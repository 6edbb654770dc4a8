// Fused error-feedback block-top-k compressor for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel`
// (src/repro/kernels/topk_compress/topk_compress.py, launched by
// `fused_compress_pallas` through `ops.py::fused_block_topk_batched`):
// the worker->master channel of the MLitB reducer. For every worker's flat
// fp32 gradient g and error-feedback residual r, both (n,), cut into rows
// of W = block_w entries (the last row zero-padded past n):
//
//   c = g + r                                  (fp32)
//   k rounds: pick the entry of largest |rem| (lowest column on ties,
//             whatever the sign), emit (rem[pick], row * W + pick),
//             set rem[pick] = 0
//   residual = rem, written back for the first n entries only
//
//   g, r      (n_workers, n)        f32, contiguous
//   vals      (n_workers, R, k)     f32    R = ceil(n / W)
//   idx       (n_workers, R, k)     int32  GLOBAL index into the (n,) buffer
//   res       (n_workers, n)        f32
//
// The worker axis folds into the row axis, so ONE launch covers every
// worker of a reduce step. Semantics kept bit-exact from the Pallas body
// (not from the JAX package's numpy oracle, which differs on NaN):
//   - a row whose values hold a NaN selects NOTHING (max |.| is NaN and
//     `mag >= NaN` is false everywhere): every round emits (0.0, row*W)
//     and the residual keeps the whole row, NaN included;
//   - an all-zero / exhausted row emits (0.0, row*W): its first column;
//   - an emitted value is rem[pick] + 0.0f, the Pallas kernel's masked sum
//     (which turns a picked -0.0 into +0.0);
//   - the zero tail padding of the last row takes part as zeros, so it
//     surfaces only as zero-valued pairs, possibly with an index >= n
//     (the reducer's scatters drop those).
//
// What bounds it on the card: bytes. Per row it reads 2W floats and
// writes W + 2k values with k rounds of a W-wide argmax, a few operations
// per byte, far below the H100's ops:bytes balance; the floor is
// (g + r read, res + vals + idx written) over HBM bandwidth. The design is
// the simple one:
//   - one warp per row; lane l holds columns l, l+32, ... (E = ceil(W/32)
//     rounded up to a power of two, a template parameter) of c in
//     registers, so each load instruction of the warp reads 128
//     contiguous bytes;
//   - each round, every lane finds its best (|v|, column) with a strict
//     `>` over increasing columns (lowest column on ties), then a 5-step
//     xor-shuffle reduction orders pairs by (|v| descending, column
//     ascending), which leaves every lane holding the winner; the owner
//     lane zeroes its register;
//   - NaN is found once per row with `__any_sync` (a NaN is never
//     picked and never zeroed, so it stays for every round);
//   - a grid-stride loop over rows with 8 warps per block.
// Vector loads, several rows per warp and a shared-memory staged epilogue
// come later.
//
// Rows wider than 1024 (32 registers a lane) take a second path,
// `fused_compress_wide_kernel`: one block of 512 threads per row (a
// grid-stride loop over rows). Thread t owns columns t, t+512, ... of
// c = g + r, staged in shared memory while the row fits (W <= 57,856
// floats, 227 KiB); a wider row works in place in `res`, which it fills
// with c first and re-reads on every round. Each round, each thread
// finds its best (|v|, column) with the same strict `>` over increasing
// columns, a shuffle reduction orders the 32 lanes' pairs and a second
// one the 16 warps' pairs by (|v| descending, column ascending); thread
// 0 emits the winner and zeroes it, and a barrier ends the round. The
// zero tail padding of the last row is not stored: a pad column only
// ties at 0 with lower real columns, so it is never the first maximum.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int E>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_compress_kernel(const float* __restrict__ g,
                      const float* __restrict__ r,
                      float* __restrict__ vals, int* __restrict__ idx,
                      float* __restrict__ res, long long n, int R, int W,
                      int k, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock
                       + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const long long w = row / R;
    const int rr = (int)(row - w * R);
    const long long col0 = (long long)rr * W;       // first column in (n,)
    const size_t base = (size_t)w * (size_t)n + (size_t)col0;
    float c[E];
    bool nan_here = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = lane + 32 * e;
      float v = 0.0f;                               // pad columns are zeros
      if (j < W && col0 + j < n) {
        v = g[base + j] + r[base + j];
        nan_here |= isnan(v);
      }
      c[e] = v;
    }
    const bool row_nan = __any_sync(kFull, nan_here);
    float* vrow = vals + row * k;
    int* irow = idx + row * k;
    for (int t = 0; t < k; ++t) {
      if (row_nan) {
        if (lane == 0) {
          vrow[t] = 0.0f;
          irow[t] = (int)col0;
        }
        continue;
      }
      float bm = -1.0f;                             // below any |v|
      int bi = INT_MAX;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = lane + 32 * e;
        const float m = fabsf(c[e]);
        if (j < W && m > bm) {
          bm = m;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(kFull, bm, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (om > bm || (om == bm && oi < bi)) {
          bm = om;
          bi = oi;
        }
      }
      float mine = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (lane + 32 * e == bi) {
          mine = c[e];
          c[e] = 0.0f;
        }
      }
      const float v = __shfl_sync(kFull, mine, bi & 31);
      if (lane == 0) {
        vrow[t] = v + 0.0f;
        irow[t] = (int)col0 + bi;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = lane + 32 * e;
      if (j < W && col0 + j < n) res[base + j] = c[e];
    }
  }
}

constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kSmemBlock = 232448;   // a Hopper block's shared memory
constexpr int kWideStatic = 1024;    // room kept for the static arrays

// (bm, bi) becomes the better of itself and (om, oi): larger |v|, then
// the lower column
__device__ __forceinline__ void take_better(float& bm, int& bi, float om,
                                            int oi) {
  if (om > bm || (om == bm && oi < bi)) {
    bm = om;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_best(float& bm, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    take_better(bm, bi, __shfl_xor_sync(kFull, bm, off),
                __shfl_xor_sync(kFull, bi, off));
}

// STAGED: the row's c lives in dynamic shared memory (W floats); else in
// res, in place.
template <bool STAGED>
__global__ void __launch_bounds__(kWideThreads)
fused_compress_wide_kernel(const float* __restrict__ g,
                           const float* __restrict__ r,
                           float* __restrict__ vals, int* __restrict__ idx,
                           float* __restrict__ res, long long n, int R, int W,
                           int k, long long rows) {
  extern __shared__ __align__(16) float c_s[];
  __shared__ float warp_m[kWideWarps];
  __shared__ int warp_i[kWideWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long w = row / R;
    const int rr = (int)(row - w * R);
    const long long col0 = (long long)rr * W;
    const size_t base = (size_t)w * (size_t)n + (size_t)col0;
    // columns of this row inside n; the rest are zero padding
    const int valid = (int)(n - col0 < W ? n - col0 : W);
    float* c = STAGED ? c_s : res + base;
    bool nan_here = false;
    for (int j = tid; j < valid; j += kWideThreads) {
      const float v = g[base + j] + r[base + j];
      nan_here |= isnan(v);
      c[j] = v;
    }
    const bool row_nan = __syncthreads_or(nan_here) != 0;
    float* vrow = vals + row * k;
    int* irow = idx + row * k;
    for (int t = 0; t < k; ++t) {
      if (row_nan) {                 // uniform over the block
        if (tid == 0) {
          vrow[t] = 0.0f;
          irow[t] = (int)col0;
        }
        continue;
      }
      float bm = -1.0f;              // below any |v|
      int bi = INT_MAX;
      for (int j = tid; j < valid; j += kWideThreads) {
        const float m = fabsf(c[j]);
        if (m > bm) {
          bm = m;
          bi = j;
        }
      }
      warp_best(bm, bi);
      if (lane == 0) {
        warp_m[warp] = bm;
        warp_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bm = lane < kWideWarps ? warp_m[lane] : -1.0f;
        bi = lane < kWideWarps ? warp_i[lane] : INT_MAX;
        warp_best(bm, bi);
        if (lane == 0) {
          vrow[t] = c[bi] + 0.0f;
          irow[t] = (int)col0 + bi;
          c[bi] = 0.0f;
        }
      }
      __syncthreads();               // the pick is zeroed for every thread
    }
    if (STAGED) {
      for (int j = tid; j < valid; j += kWideThreads) res[base + j] = c_s[j];
      __syncthreads();               // the buffer is the next row's
    }
  }
}

cudaError_t launch_wide(const float* g, const float* r, float* vals,
                        int* idx, float* res, long long n, int R, int W,
                        int k, long long rows, cudaStream_t s) {
  long long blocks = rows < 132LL * 16 ? rows : 132LL * 16;
  const long long bytes = 4LL * W;
  if (bytes + kWideStatic <= kSmemBlock) {
    auto kern = fused_compress_wide_kernel<true>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (attr != cudaSuccess) return attr;
    kern<<<(unsigned)blocks, kWideThreads, (size_t)bytes, s>>>(
        g, r, vals, idx, res, n, R, W, k, rows);
  } else {
    fused_compress_wide_kernel<false><<<(unsigned)blocks, kWideThreads, 0,
                                        s>>>(g, r, vals, idx, res, n, R, W,
                                             k, rows);
  }
  return cudaGetLastError();
}

template <int E>
cudaError_t launch(const float* g, const float* r, float* vals, int* idx,
                   float* res, long long n, int R, int W, int k,
                   long long rows, cudaStream_t s) {
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 132LL * 64) blocks = 132LL * 64;     // grid-stride past this
  fused_compress_kernel<E><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
      g, r, vals, idx, res, n, R, W, k, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` of card `device`; returns a cudaError_t (0 on
// success). The wrapper has checked W >= 1, 1 <= k <= W and R * W <= 2^31
// (a worker's indices are int32).
int fused_compress_launch(const void* g, const void* r, void* vals,
                          void* idx, void* res, long long n, int n_workers,
                          int W, int k, int device, void* stream) {
  const int R = (int)((n + W - 1) / W);
  const long long rows = (long long)n_workers * R;
  if (rows == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const float* rp = static_cast<const float*>(r);
  float* vp = static_cast<float*>(vals);
  int* ip = static_cast<int*>(idx);
  float* qp = static_cast<float*>(res);
  const int per_lane = (W + 31) / 32;
  cudaError_t err;
  if (per_lane > 32) {
    err = launch_wide(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 1) {
    err = launch<1>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 2) {
    err = launch<2>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 4) {
    err = launch<4>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 8) {
    err = launch<8>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 16) {
    err = launch<16>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else {
    err = launch<32>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
