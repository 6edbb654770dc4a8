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
// writes W + 2k values, a few operations per byte, far below the H100's
// ops:bytes balance; the floor is (g + r read, res + vals + idx written)
// over HBM bandwidth. The wrapper's plan (`ops.py` `route`) picks one of
// three kernels by (W, k) and passes its choice in:
//
// WARP (W <= 512, the reducer's default 128): one warp per row; lane l
// holds columns l, l+32, ... (E = ceil(W/32) rounded up to a power of
// two, at most 16, a template parameter) of c in registers, so each load
// instruction of the warp reads 128 contiguous bytes. Each of the k
// rounds, every lane finds its best (|v|, column) with a strict `>` over
// increasing columns (lowest column on ties), then a 5-step xor-shuffle
// reduction orders pairs by (|v| descending, column ascending), which
// leaves every lane holding the winner; the owner lane zeroes its
// register. NaN is found once per row with `__any_sync`. A grid-stride
// loop over rows with 8 warps per block. Past W 512 the select kernel is
// the faster (W 640-1024 on the H100), so E stops at 16.
//
// SELECT (W > 512 while the row and its picks fit in shared memory): one
// block per row, a persistent grid over rows, and a cost per row that
// does not grow with k. What the k rounds compute is, per row: with
// m = #(|c| > 0) and k' = min(k, m), the k' largest entries under
// (|c| descending, column ascending), in that order, then k - k' pairs
// (+0.0, col0), and if any such pad is emitted the residual's column 0
// becomes +0.0 (the rounds zero it, -0.0 included). The 31-bit key
// `bits(c) & 0x7fffffff` is monotone in |c| for every non-NaN float
// (subnormals and inf included; no -ftz, no fast math), so the kernel
// works on integer keys:
//   - stage: g and r in 16-byte vector loads (a scalar head and tail
//     where the row is not 16-byte aligned), c = g + r written to res at
//     once (the residual before its picks are zeroed) and into shared
//     memory (rows past shared memory: to res only, and read back from
//     it), while counting m, flagging NaN (`__syncthreads_or`) and
//     building the histogram of the nonzero keys' top 8 bits;
//   - select: if k >= m the picks are every nonzero; else a radix select
//     finds T, the k'-th largest key, in at most four digit passes
//     (8, 8, 8, 7 bits from the top), each a histogram of the nonzero
//     keys that share the prefix so far (one per pass, so none is
//     cleared inside the row) after which every warp scans the 256 bins
//     by itself, with no further barrier; a pass stops the select as soon
//     as the chosen bucket is taken whole. The keys equal to T that are
//     taken are the lowest columns: a block-wide prefix count of ties
//     over contiguous column runs (one run per warp, ballots within it);
//   - order and emit: the k' picks, packed as (key << 32 | ~column),
//     are compacted into shared memory and sorted descending: up to 256 in
//     one warp's registers (bitonic, shuffles, no block barrier), more by
//     a block-wide bitonic sort in shared memory. Values c[col] + 0.0f and
//     indices are written in order, the picks zeroed in res, then the
//     pads and the rule for column 0.
// A row costs a fixed number of block barriers (staging, one a digit
// pass, the tie count, the compaction, the end of the row), not the
// rounds' 2k. 128 threads a row up to W 4096, 256 above, at most 64
// registers, so 8 (4) rows are in flight on a SM: the load of one row
// overlaps the others' selects. (A two-stage cp.async ring of the next
// row's g and r, per-warp histograms with one block scan each, warp-
// aggregated atomics (`__match_any_sync`) and an L2 prefetch of the next
// row were each slower on the H100.)
//
// ROUNDS (a (W, k) whose picks' sort buffer does not fit in shared
// memory, k past 16 384): the earlier block-per-row kernel, k
// barrier-bound rounds. One
// block of 512 threads per row (a grid-stride loop over rows). Thread t
// owns columns t, t+512, ... of c, staged in shared memory while the row
// fits (W <= 57,856 floats, 227 KiB); a wider row works in place in
// `res`, which it fills with c first and re-reads on every round. Each
// round, each thread finds its best (|v|, column) with the same strict
// `>` over increasing columns, a shuffle reduction orders the 32 lanes'
// pairs and a second one the 16 warps' pairs by (|v| descending, column
// ascending); thread 0 emits the winner and zeroes it, and a barrier ends
// the round. The zero tail padding of the last row is not stored: a pad
// column only ties at 0 with lower real columns, so it is never the
// first maximum.

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

// ---------------------------------------------------------------------------
// SELECT: radix select and one ordered emission per row
// ---------------------------------------------------------------------------
constexpr int kBins = 256;           // one 8-bit digit
constexpr int kPasses = 4;           // digits of 8, 8, 8 and 7 bits
constexpr int kRegSort = 256;        // picks sorted in one warp's registers
constexpr int kSelectStatic = 1024;  // room kept for the static arrays

__host__ __device__ __forceinline__ int select_threads(int W) {
  return W <= 4096 ? 128 : 256;
}

// the smallest power of two >= x, at least 32
__host__ __device__ __forceinline__ long long sort_slots(long long x) {
  long long p = 32;
  while (p < x) p <<= 1;
  return p;
}

// one staged row's bytes: W + 3 floats (its first vector column is moved
// onto a 16-byte boundary), rounded up to 16 bytes
__host__ __device__ __forceinline__ long long staged_row_bytes(int W) {
  return (4LL * (W + 3) + 15) / 16 * 16;
}

// dynamic shared memory of the select kernel: the staged row (none in
// place), the sort buffer for min(k, W) picks, one histogram per pass
long long select_smem_bytes(int W, int k, bool staged) {
  const long long kk = k < W ? k : W;
  return (staged ? staged_row_bytes(W) : 0) + 8 * sort_slots(kk)
         + 4LL * kPasses * kBins;
}

__device__ __forceinline__ unsigned mag_key(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Sort 32 * E packed picks (element e * 32 + lane in v[e]) descending:
// bitonic, partners past 32 in the lane's own registers, within 32 by
// shuffles. Uniform over the warp.
template <int E>
__device__ __forceinline__ void warp_sort_desc(unsigned long long (&v)[E],
                                               int lane) {
  constexpr int kLog = E == 1 ? 5 : E == 2 ? 6 : E == 4 ? 7 : 8;
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
    const int size = 1 << ls;
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (lj >= 5) {
        const int je = j >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & je) == 0) {
            const bool desc = ((e * 32 + lane) & size) == 0;
            const unsigned long long a = v[e], b = v[e | je];
            if (desc ? a < b : a > b) {
              v[e] = b;
              v[e | je] = a;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * 32 + lane;
          const unsigned long long o = __shfl_xor_sync(kFull, v[e], j);
          const bool keep_max = ((i & j) == 0) == ((i & size) == 0);
          v[e] = keep_max ? (v[e] > o ? v[e] : o) : (v[e] < o ? v[e] : o);
        }
      }
    }
  }
}

// Emit sorted pick `i` (packed p): value c[col] + 0.0f, global index, and
// the pick zeroed in the residual (read before written: in place, c is res).
__device__ __forceinline__ void emit_pick(int i, unsigned long long p,
                                          const float* c, float* rrow,
                                          float* vrow, int* irow,
                                          long long col0) {
  const int col = (int)(0xffffffffu - (unsigned)p);
  const float v = c[col];
  vrow[i] = v + 0.0f;
  irow[i] = (int)(col0 + col);
  rrow[col] = 0.0f;
}

template <int E>
__device__ __forceinline__ void warp_sort_emit(
    const unsigned long long* cand, int kk, int lane, const float* c,
    float* rrow, float* vrow, int* irow, long long col0) {
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < kk ? cand[i] : 0ull;
  }
  warp_sort_desc<E>(v, lane);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < kk) emit_pick(i, v[e], c, rrow, vrow, irow, col0);
  }
}

// The bucket of a pass: over the 256 bins of histogram h, the bin b with
// #(keys in bins > b) < needed <= #(keys in bins >= b). Every warp finds
// it by itself (lane l holds bins 8l..8l+7), so no barrier follows.
// Returns b; `above` and `cnt` get the counts above it and in it.
__device__ __forceinline__ unsigned find_bucket(const unsigned* h,
                                                unsigned needed, int lane,
                                                unsigned& above,
                                                unsigned& cnt) {
  const uint4 lo4 = reinterpret_cast<const uint4*>(h)[2 * lane];
  const uint4 hi4 = reinterpret_cast<const uint4*>(h)[2 * lane + 1];
  const unsigned b[8] = {lo4.x, lo4.y, lo4.z, lo4.w,
                         hi4.x, hi4.y, hi4.z, hi4.w};
  unsigned tot = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) tot += b[i];
  unsigned incl = tot;                         // keys in lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += o;
  }
  unsigned hi = incl - tot;                    // keys in bins > 8l + 7
  int mine = -1;
  unsigned my_lo = 0u, my_cnt = 0u;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    const unsigned lo = hi;
    hi += b[i];
    if (mine < 0 && lo < needed && needed <= hi) {
      mine = i;
      my_lo = lo;
      my_cnt = b[i];
    }
  }
  const int owner = __ffs(__ballot_sync(kFull, mine >= 0)) - 1;
  above = __shfl_sync(kFull, my_lo, owner);
  cnt = __shfl_sync(kFull, my_cnt, owner);
  return (unsigned)(8 * owner + __shfl_sync(kFull, mine, owner));
}

// NT threads per row. STAGED keeps c in shared memory, else c is read
// back from res (rows past shared memory). `pmax` = sort_slots(k).
template <int NT, bool STAGED>
__global__ void __launch_bounds__(NT, 1024 / NT)
fused_compress_select_kernel(const float* __restrict__ g,
                             const float* __restrict__ r,
                             float* __restrict__ vals, int* __restrict__ idx,
                             float* __restrict__ res, long long n, int R,
                             int W, int k, long long rows, int pmax,
                             int vec) {
  constexpr int NW = NT / 32;
  constexpr int U = 2;                   // vector loads in flight a thread
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row_bytes = STAGED ? staged_row_bytes(W) : 0;
  float* c_s = reinterpret_cast<float*>(smem);
  unsigned long long* cand =
      reinterpret_cast<unsigned long long*>(smem + row_bytes);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + row_bytes + 8LL * pmax);
  __shared__ unsigned s_m[2];            // nonzeros, by row parity
  __shared__ unsigned s_cnt;             // picks compacted so far
  __shared__ unsigned s_wsum[NW];        // per-warp tie counts
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int i = tid; i < kPasses * kBins; i += NT) hist[i] = 0u;
  if (tid == 0) {
    s_m[0] = 0u;
    s_m[1] = 0u;
  }
  __syncthreads();
  int parity = 0;
  for (long long row = blockIdx.x; row < rows;
       row += gridDim.x, parity ^= 1) {
    const long long w = row / R;
    const long long col0 = (row - w * R) * (long long)W;
    const size_t base = (size_t)w * (size_t)n + (size_t)col0;
    const int valid = (int)(n - col0 < W ? n - col0 : W);
    const float* grow = g + base;
    const float* rin = r + base;
    float* rrow = res + base;
    // columns [0, head) and [tail, valid) scalar, [head, tail) in float4s
    int head = valid;
    if (vec) {
      const int mis = (int)((reinterpret_cast<size_t>(grow) >> 2) & 3);
      head = min(valid, (4 - mis) & 3);
    }
    const int quads = (valid - head) >> 2;
    const int tail = head + 4 * quads;
    // c[j] lives at cs[j]; cs + head is 16-byte aligned
    float* cs = c_s + ((4 - head) & 3);
    const float* c = STAGED ? cs : rrow;
    if (tid == 0) s_cnt = 0u;
    // ---- stage: c = g + r, to res and shared memory; m, NaN, pass 0 ----
    // (zero keys stay out of every histogram: the picks are nonzero)
    bool nan_here = false;
    unsigned nz = 0;
    auto take = [&](float v) {
      const unsigned key = mag_key(v);
      nan_here |= key > 0x7f800000u;
      if (key != 0u) {
        ++nz;
        atomicAdd(&hist[key >> 23], 1u);
      }
    };
    auto scalar = [&](int j) {
      const float v = grow[j] + rin[j];
      rrow[j] = v;
      if (STAGED) cs[j] = v;
      take(v);
    };
    for (int j = tid; j < head; j += NT) scalar(j);
    for (int j = tail + tid; j < valid; j += NT) scalar(j);
    {
      float4* q4 = reinterpret_cast<float4*>(rrow + head);
      float4* c4 = reinterpret_cast<float4*>(cs + head);
      const float4* g4 = reinterpret_cast<const float4*>(grow + head);
      const float4* r4 = reinterpret_cast<const float4*>(rin + head);
      for (int q0 = tid; q0 < quads; q0 += NT * U) {
        float4 a[U], b[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = q0 + u * NT;
          if (i < quads) {
            a[u] = g4[i];
            b[u] = r4[i];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = q0 + u * NT;
          if (i < quads) {
            const float4 v = make_float4(a[u].x + b[u].x, a[u].y + b[u].y,
                                         a[u].z + b[u].z, a[u].w + b[u].w);
            q4[i] = v;
            if (STAGED) c4[i] = v;
            take(v.x);
            take(v.y);
            take(v.z);
            take(v.w);
          }
        }
      }
    }
    nz = __reduce_add_sync(kFull, nz);
    if (lane == 0 && nz) atomicAdd(&s_m[parity], nz);
    const bool row_nan = __syncthreads_or(nan_here) != 0;
    const int m = (int)s_m[parity];
    if (tid == 0) s_m[parity ^ 1] = 0u;
    float* vrow = vals + row * k;
    int* irow = idx + row * k;
    // a NaN row picks nothing and keeps c; else k' = min(k, m) picks
    const int kk = row_nan ? 0 : min(k, m);
    // pads (+0.0, col0); with one, column 0 ends +0.0 (a nonzero c[0] is
    // a pick, zeroed by its emitter)
    for (int t = kk + tid; t < k; t += NT) {
      vrow[t] = 0.0f;
      irow[t] = (int)col0;
      if (t == kk && !row_nan && mag_key(c[0]) == 0u) rrow[0] = 0.0f;
    }
    // ---- select: picks are key > thr, then the first need_eq key == thr
    int thr = 0;                     // every nonzero, or none
    int need_eq = 0;
    if (kk > 0 && kk < m) {
      unsigned prefix = 0u;
      int needed = kk;
      int hi_shift = 31;
      bool whole = false;
      for (int p = 0; p < kPasses; ++p) {
        const int shift = p < 3 ? 23 - 8 * p : 0;
        const int bits = p < 3 ? 8 : 7;
        unsigned* h = hist + p * kBins;
        if (p > 0) {                 // pass 0's histogram is the staging's
          for (int j = tid; j < valid; j += NT) {
            const unsigned key = mag_key(c[j]);
            if (key != 0u && (key >> hi_shift) == prefix)
              atomicAdd(&h[(key >> shift) & ((1u << bits) - 1u)], 1u);
          }
          __syncthreads();
        }
        unsigned above, cnt;
        const unsigned bin = find_bucket(h, (unsigned)needed, lane, above,
                                         cnt);
        needed -= (int)above;
        prefix = (prefix << bits) | bin;
        hi_shift = shift;
        if ((int)cnt == needed) {    // the bucket's nonzeros go whole
          thr = max((int)(prefix << shift) - 1, 0);
          whole = true;
          break;
        }
      }
      if (!whole) {
        thr = (int)prefix;
        need_eq = needed;
      }
    }
    // ---- compact the picks; warp `warp` owns columns [j0, j1) ----------
    const int chunk = (valid + 32 * NW - 1) / (32 * NW) * 32;
    const int j0 = warp * chunk;
    const int j1 = min(j0 + chunk, valid);
    unsigned tie_base = 0u;
    if (need_eq > 0) {               // ties: lowest columns
      unsigned tc = 0u;
      for (int j = j0 + lane; j - lane < j1; j += 32) {
        const bool tie = j < j1 && (int)mag_key(c[j]) == thr;
        tc += __popc(__ballot_sync(kFull, tie));
      }
      if (lane == 0) s_wsum[warp] = tc;
      __syncthreads();
      for (int w2 = 0; w2 < warp; ++w2) tie_base += s_wsum[w2];
    }
    if (kk > 0) {
      for (int j = j0 + lane; j - lane < j1; j += 32) {
        const bool in = j < j1;
        const unsigned key = in ? mag_key(c[j]) : 0u;
        bool sel = in && (int)key > thr;
        if (need_eq > 0) {
          const bool tie = in && (int)key == thr;
          const unsigned b = __ballot_sync(kFull, tie);
          sel = sel || (tie && tie_base + __popc(b & lt) < (unsigned)need_eq);
          tie_base += __popc(b);
        }
        const unsigned sb = __ballot_sync(kFull, sel);
        if (sb) {
          unsigned at = 0u;
          if (lane == 0) at = atomicAdd(&s_cnt, (unsigned)__popc(sb));
          at = __shfl_sync(kFull, at, 0);
          if (sel)
            cand[at + __popc(sb & lt)] =
                ((unsigned long long)key << 32) | (0xffffffffu - (unsigned)j);
        }
      }
    }
    __syncthreads();                 // picks compacted; histograms read
    for (int i = tid; i < kPasses * kBins; i += NT) hist[i] = 0u;
    // ---- order and emit -------------------------------------------------
    if (kk > 0) {
      const int slots = (int)sort_slots(kk);
      if (slots <= kRegSort) {
        if (warp == 0) {
          if (slots == 32)
            warp_sort_emit<1>(cand, kk, lane, c, rrow, vrow, irow, col0);
          else if (slots == 64)
            warp_sort_emit<2>(cand, kk, lane, c, rrow, vrow, irow, col0);
          else if (slots == 128)
            warp_sort_emit<4>(cand, kk, lane, c, rrow, vrow, irow, col0);
          else
            warp_sort_emit<8>(cand, kk, lane, c, rrow, vrow, irow, col0);
        }
      } else {
        for (int i = kk + tid; i < slots; i += NT) cand[i] = 0ull;
        __syncthreads();
        for (int size = 2; size <= slots; size <<= 1) {
          for (int j = size >> 1; j > 0; j >>= 1) {
            for (int i = tid; i < slots; i += NT) {
              const int ij = i ^ j;
              if (ij > i) {
                const unsigned long long a = cand[i], b = cand[ij];
                if ((i & size) == 0 ? a < b : a > b) {
                  cand[i] = b;
                  cand[ij] = a;
                }
              }
            }
            __syncthreads();
          }
        }
        for (int i = tid; i < kk; i += NT)
          emit_pick(i, cand[i], c, rrow, vrow, irow, col0);
      }
    }
    __syncthreads();                 // shared memory is the next row's
  }
}

template <int NT, bool STAGED>
cudaError_t launch_select_as(const float* g, const float* r, float* vals,
                             int* idx, float* res, long long n, int R, int W,
                             int k, long long rows, int vec, int device,
                             cudaStream_t s) {
  auto kern = fused_compress_select_kernel<NT, STAGED>;
  const long long bytes = select_smem_bytes(W, k, STAGED);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                      (size_t)bytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long full = (long long)per_sm * sms;
  const long long blocks = rows < full ? rows : full;
  kern<<<(unsigned)blocks, NT, (size_t)bytes, s>>>(
      g, r, vals, idx, res, n, R, W, k, rows,
      (int)sort_slots(k < W ? k : W), vec);
  return cudaGetLastError();
}

cudaError_t launch_select(const float* g, const float* r, float* vals,
                          int* idx, float* res, long long n, int R, int W,
                          int k, long long rows, bool staged, int vec,
                          int device, cudaStream_t s) {
  if (select_smem_bytes(W, k, staged) + kSelectStatic > kSmemBlock)
    return cudaErrorInvalidValue;
  if (select_threads(W) == 128)
    return staged ? launch_select_as<128, true>(g, r, vals, idx, res, n, R,
                                                W, k, rows, vec, device, s)
                  : launch_select_as<128, false>(g, r, vals, idx, res, n, R,
                                                 W, k, rows, vec, device, s);
  return staged ? launch_select_as<256, true>(g, r, vals, idx, res, n, R, W,
                                              k, rows, vec, device, s)
                : launch_select_as<256, false>(g, r, vals, idx, res, n, R, W,
                                               k, rows, vec, device, s);
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

// The routes, as `ops.py` names them.
enum Route { kWarp = 0, kSelect = 1, kSelectInPlace = 2, kRounds = 3 };

// Dynamic shared memory of the select kernel for rows of W and k picks,
// staged (the row in shared memory) or not; `ops.py` keeps a copy.
long long fused_compress_smem_bytes(int W, int k, int staged) {
  return select_smem_bytes(W, k, staged != 0);
}

// Launch `route` on `stream` of card `device`; returns a cudaError_t (0
// on success, cudaErrorInvalidValue for a route that does not take this
// (W, k)). The wrapper has checked W >= 1, 1 <= k <= W and R * W <= 2^31
// (a worker's indices are int32).
int fused_compress_launch(const void* g, const void* r, void* vals,
                          void* idx, void* res, long long n, int n_workers,
                          int W, int k, int route, int device, void* stream) {
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
  if (route == kSelect || route == kSelectInPlace) {
    // 16-byte vectors when g, r and res sit alike against 16 bytes
    const size_t a = reinterpret_cast<size_t>(g) & 15;
    const int vec = (a & 3) == 0 && (reinterpret_cast<size_t>(r) & 15) == a
                    && (reinterpret_cast<size_t>(res) & 15) == a;
    err = launch_select(gp, rp, vp, ip, qp, n, R, W, k, rows,
                        route == kSelect, vec, device, s);
  } else if (route == kRounds) {
    err = launch_wide(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (route != kWarp || per_lane > 16) {
    err = cudaErrorInvalidValue;
  } else if (per_lane <= 1) {
    err = launch<1>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 2) {
    err = launch<2>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 4) {
    err = launch<4>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else if (per_lane <= 8) {
    err = launch<8>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  } else {
    err = launch<16>(gp, rp, vp, ip, qp, n, R, W, k, rows, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
