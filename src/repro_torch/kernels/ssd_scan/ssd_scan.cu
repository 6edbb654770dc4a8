// Mamba2 SSD chunked scan for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/ssd_scan.py, launched by `ssd_scan_pallas`
// through `ops.py::ssd_scan`): the state-space-duality form of the Mamba2
// recurrence, chunk by chunk, one group (g = 1) shared by all heads.
//
//   x      (B, S, nh, hd)   float32 or bfloat16
//   dt     (B, S, nh)       the same type, after softplus
//   A      (nh,)            float32, negative decay rates
//   Bm, Cm (B, S, N)        the same type as x
//   y      (B, S, nh, hd)   x's type; all arithmetic is float32
//
// For each (b, h) and each chunk of Q steps, with cum the running sum of
// dt * A[h] inside the chunk (summed in order, as a cumsum):
//   seg = min(cum_i - cum_j, 0)          clamped BEFORE exp, as the TPU
//                                        kernel does (j > i would overflow)
//   G   = (C B^T) * exp(seg) * dt_j      for j <= i, else 0
//   y   = G x + exp(cum_i) * (C h^T)     h: the (hd, N) state entering
//   h  <- h * exp(cum_Q) + sum_j dt_j exp(cum_Q - cum_j) x_j B_j^T
// The chunk is Q <= 128 steps, any length (the wrapper passes
// min(chunk, S)); steps past S in the last chunk read as dt = 0, x = B =
// C = 0 (no decay, no input), which is what the JAX wrapper's zero
// padding gives, and their y is not written: no padded copy.
//
// What bounds it on the card: operations. Per (b, h, chunk) the work is
// about Q^2 N / 2 (C B^T, causal half) + Q^2 hd / 2 (G x) + 2 Q N hd (the
// state's read-out and update) multiply-adds against (2 Q N + 2 Q hd)
// values read and written, so float32 FMAs on the CUDA cores, not HBM,
// set the floor. The design:
//   - the TPU's sequential chunk axis (state carried in VMEM between grid
//     steps) becomes a loop inside one CTA per (head, batch row), which
//     keeps the (hd, N) state in shared memory across chunks. That is
//     nh * B CTAs (192 at B = 4, nh = 48): enough for the 132 SMs at B >= 3
//     but not at B = 1; splitting a row's chunks across CTAs (a second
//     pass over chunk states) is later work;
//   - the per-chunk working set at Q = N = 128, hd = 64 in float32 (B and
//     C 64 KB each, x 32 KB, the state 32 KB, the Q x Q matrix G 64 KB) is
//     more than a block's 227 KB, so G is built 32 rows at a time: warp w
//     builds rows 4w..4w+3 of a 32-row block and reads back only its own
//     rows for y (a __syncwarp, no block barrier); with it the CTA takes
//     about 218 KB, one CTA per SM;
//   - row strides are padded by 4 floats, so the 16-byte loads along N
//     are free of bank conflicts; a warp's C rows are broadcasts;
//   - the causal half: a warp's G rows only reach column 4w + 3 of the
//     block, so only those 32-column groups of C B^T are computed, and
//     y's G x loop stops there too.
// C B^T is the same for every head of a batch row; computing it once per
// (b, chunk) for several heads, and tensor cores, come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBlock = 4 * kWarps;   // rows of G built at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float lane_of(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// floats of dynamic shared memory for one CTA
__host__ __device__ __forceinline__ long long smem_floats(int Q, int N,
                                                          int hd) {
  const long long Q4 = round4(Q);
  return 2 * Q4 * (N + 4) + Q4 * (hd + 4) + (long long)hd * (N + 4)
         + kRowBlock * (Q4 + 4) + 4 * Q4;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, int S, int nh,
                int N, int Q) {
  constexpr int PY = HD / 32;      // y columns per lane
  constexpr int PH = HD / 8;       // state rows per warp
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Q4 = round4(Q);
  const int LDN = N + 4;
  const int LDX = HD + 4;
  const int LDG = Q4 + 4;

  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);   // Q4 x LDN
  float* Cs = Bs + Q4 * LDN;                     // Q4 x LDN
  float* Xs = Cs + Q4 * LDN;                     // Q4 x LDX
  float* Hs = Xs + Q4 * LDX;                     // HD x LDN: the state
  float* Gs = Hs + HD * LDN;                     // kRowBlock x LDG
  float* cum = Gs + kRowBlock * LDG;             // Q4
  float* dts = cum + Q4;                         // Q4
  float* wv = dts + Q4;                          // Q4: dt_j exp(cum_Q - cum_j)
  float* ev = wv + Q4;                           // Q4: exp(cum_i)

  for (int e = tid; e < HD * LDN; e += kThreads) Hs[e] = 0.0f;
  const float a = A[h];
  const int nv = N / 4;
  constexpr int xv = HD / 4;
  const size_t xstep = (size_t)nh * HD;          // x's stride per step

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int valid = min(Q, S - s0);
    __syncthreads();        // the last chunk's state update is done
    const T* Bb = Bm + ((size_t)b * S + s0) * N;
    const T* Cb = Cm + ((size_t)b * S + s0) * N;
    for (int e = tid; e < Q4 * nv; e += kThreads) {
      const int r = e / nv;
      const int n = (e - r * nv) * 4;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const bool in = r < valid;
      *reinterpret_cast<float4*>(Bs + r * LDN + n) =
          in ? load4(Bb + (size_t)r * N + n) : z;
      *reinterpret_cast<float4*>(Cs + r * LDN + n) =
          in ? load4(Cb + (size_t)r * N + n) : z;
    }
    const T* xb = x + (((size_t)b * S + s0) * nh + h) * HD;
    for (int e = tid; e < Q4 * xv; e += kThreads) {
      const int r = e / xv;
      const int p = (e - r * xv) * 4;
      *reinterpret_cast<float4*>(Xs + r * LDX + p) =
          r < valid ? load4(xb + (size_t)r * xstep + p)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = tid; r < Q4; r += kThreads)
      dts[r] = r < valid ? to_f32(dt[((size_t)b * S + s0 + r) * nh + h])
                         : 0.0f;
    __syncthreads();
    if (tid == 0) {          // Q <= 128 dependent adds, in cumsum's order
      float run = 0.0f;
      for (int r = 0; r < Q4; ++r) {
        if (r < Q) run += dts[r] * a;
        cum[r] = r < Q ? run : 0.0f;
      }
    }
    __syncthreads();
    const float cQ = cum[Q - 1];
    for (int r = tid; r < Q4; r += kThreads) {
      ev[r] = r < Q ? expf(cum[r]) : 0.0f;
      wv[r] = r < Q ? dts[r] * expf(cQ - cum[r]) : 0.0f;
    }
    __syncthreads();

    // y, 32 rows at a time; warp w owns rows rb .. rb + 3
    for (int i0 = 0; i0 < Q; i0 += kRowBlock) {
      const int rb = i0 + 4 * warp;
      if (rb >= Q) continue;                    // warp-uniform
      const int jlim = min(Q, rb + 4);          // G[i][j] = 0 for j >= jlim
      const int groups = (jlim + 31) / 32;      // 32-column groups to build
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) g[i][jj] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 c4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c4[i] = *reinterpret_cast<const float4*>(Cs + (rb + i) * LDN + n);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = lane + 32 * jj;
          if (jj < groups && j < Q) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(Bs + j * LDN + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) g[i][jj] = dot4(c4[i], b4, g[i][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = rb + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = lane + 32 * jj;
          if (j < Q4) {
            float gv = 0.0f;
            if (ri < Q && j <= ri)
              gv = g[i][jj] * expf(fminf(cum[ri] - cum[j], 0.0f)) * dts[j];
            Gs[(4 * warp + i) * LDG + j] = gv;
          }
        }
      }
      __syncwarp();

      float yi[4][PY], yo[4][PY];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int pp = 0; pp < PY; ++pp) yi[i][pp] = yo[i][pp] = 0.0f;
      const int jend = round4(jlim);
      for (int j = 0; j < jend; j += 4) {
        float4 g4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          g4[i] = *reinterpret_cast<const float4*>(Gs + (4 * warp + i) * LDG
                                                   + j);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int pp = 0; pp < PY; ++pp) {
            const float xvv = Xs[(j + cc) * LDX + lane + 32 * pp];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              yi[i][pp] = fmaf(lane_of(g4[i], cc), xvv, yi[i][pp]);
          }
        }
      }
      for (int n = 0; n < N; n += 4) {
        float4 c4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          c4[i] = *reinterpret_cast<const float4*>(Cs + (rb + i) * LDN + n);
#pragma unroll
        for (int pp = 0; pp < PY; ++pp) {
          const float4 h4 = *reinterpret_cast<const float4*>(
              Hs + (lane + 32 * pp) * LDN + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) yo[i][pp] = dot4(c4[i], h4, yo[i][pp]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = rb + i;
        if (ri >= valid) continue;
        T* yrow = y + (((size_t)b * S + s0 + ri) * nh + h) * HD;
#pragma unroll
        for (int pp = 0; pp < PY; ++pp)
          store(yrow + lane + 32 * pp, yi[i][pp] + ev[ri] * yo[i][pp]);
      }
      __syncwarp();         // the next row block rewrites this warp's rows
    }
    __syncthreads();        // every y has read the entering state

    // state: h <- h exp(cum_Q) + sum_j w_j x_j B_j^T; warp w owns rows
    // w, w + 8, ... of h, lane l columns l, l + 32, ... (128 at a time)
    const float eQ = expf(cQ);
    for (int nb = 0; nb < N; nb += 128) {
      float acc[PH][4];
#pragma unroll
      for (int pp = 0; pp < PH; ++pp)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) acc[pp][nn] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        const float wj = wv[j];
        float xw[PH], bv[4];
#pragma unroll
        for (int pp = 0; pp < PH; ++pp)
          xw[pp] = Xs[j * LDX + warp + kWarps * pp] * wj;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int n = nb + lane + 32 * nn;
          bv[nn] = n < N ? Bs[j * LDN + n] : 0.0f;
        }
#pragma unroll
        for (int pp = 0; pp < PH; ++pp)
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
            acc[pp][nn] = fmaf(xw[pp], bv[nn], acc[pp][nn]);
      }
#pragma unroll
      for (int pp = 0; pp < PH; ++pp)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int n = nb + lane + 32 * nn;
          if (n < N) {
            float* hp = Hs + (warp + kWarps * pp) * LDN + n;
            *hp = *hp * eQ + acc[pp][nn];
          }
        }
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, int Bsz, int S,
                   int nh, int N, int Q, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(Q, N, HD);
  auto kern = ssd_scan_kernel<HD, T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3(nh, Bsz), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, nh, N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, int Bsz, int S,
                     int nh, int hd, int N, int Q, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<32, T>(x, dt, A, Bm, Cm, y, Bsz, S, nh, N, Q, s);
    case 64:
      return launch<64, T>(x, dt, A, Bm, Cm, y, Bsz, S, nh, N, Q, s);
    case 128:
      return launch<128, T>(x, dt, A, Bm, Cm, y, Bsz, S, nh, N, Q, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of card `device`; returns a cudaError_t (0 on
// success). The wrapper has checked hd in {32, 64, 128}, N % 4 == 0,
// 1 <= Q <= 128, the shared memory, contiguity, alignment and the type
// (is_bf16: 0 float32, 1 bfloat16; A is float32).
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int Bsz, int S,
                    int nh, int hd, int N, int Q, int is_bf16, int device,
                    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, Bsz, S, nh, hd,
                                        N, Q, s)
              : dispatch<float>(x, dt, A, Bm, Cm, y, Bsz, S, nh, hd, N, Q,
                                s);
  return static_cast<int>(err);
}

// Dynamic shared memory one CTA takes for chunk Q, state N and head dim hd.
long long ssd_scan_smem_bytes(int Q, int N, int hd) {
  return (long long)sizeof(float) * smem_floats(Q, N, hd);
}

}  // extern "C"
