// Blockwise online-softmax attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py, launched by
// `flash_attention_pallas` through `ops.py::flash_attention`): causal and
// sliding-window attention with GQA, query head h reading kv head
// h / (H / K).
//
//   q    (B, H, S, D)   float32 or bfloat16, contiguous
//   k, v (B, K, T, D)   the same type
//   out  (B, H, S, D)   q's type; all arithmetic is float32
//
// Semantics kept from the TPU kernel: scale D^-0.5; masks by absolute
// positions, both aligned at 0 (key t is valid for query s when t <= s
// under `causal` and t > s - window under `window`); online softmax with
// NEG_INF = -1e30, the alpha guard for a running max still at NEG_INF and
// a max(l, 1e-30) denominator, so a row that sees no valid key comes out
// as exact zeros. One difference, on purpose: keys past T are masked.
// The JAX wrapper pads T to a block multiple and lets the zero keys into
// the softmax when `causal` is off; here they never enter it, and the
// result equals the reference `attention_ref`.
//
// What bounds it on the card: operations. A (64 x D) query tile meets
// every key it may see, 4 D flops per (query, key) pair, against 2 D
// values of K/V read per key and tile; at the served shapes that is far
// above the card's bytes:flops balance for float32 on the CUDA cores
// (this kernel does not use the tensor cores: f32 stays f32 and bf16 is
// widened to f32, as in the TPU kernel's math). The design is the simple
// one:
//   - one CTA of 256 threads per (64-query tile, head, batch row); tiles
//     are launched in reverse so the causal tiles with the most keys
//     start first;
//   - the loop over key tiles (the TPU grid's sequential KV axis) covers
//     only the tiles the masks leave some key in: causal stops at the
//     tile's last query, a window starts at its first query - window + 1
//     (skipping a fully masked tile is exact: it would leave m, l and acc
//     as they are);
//   - Q, K and V tiles are staged in shared memory as float32 with a
//     padded row stride (D + 4 floats: 16-byte aligned rows, no bank
//     conflicts for the 16-byte loads below); above 48 KB the kernel
//     opts in to dynamic shared memory;
//   - scores: a 16 x 16 thread grid, each thread 4 query rows x (BK/16)
//     keys (keys strided by 16), 16-byte loads along D; a query row's
//     16 threads sit in one half-warp, so its max and sum are 4 xor
//     shuffles, and m, l live in registers;
//   - P goes through shared memory to the P.V product, where each thread
//     owns the same 4 rows and D/16 output columns in registers (read
//     back only by its own half-warp, so a __syncwarp suffices).
// Key tiles are BK = 64 for D <= 64 and 32 above, which keeps shared
// memory at 45-142 KB. Tensor cores (mma/wgmma for bf16, split-K
// for long rows) and cp.async/TMA double buffering are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;                // query rows per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// four consecutive elements as floats (16-byte / 8-byte aligned loads)
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

template <int D>
struct Tiles {
  static constexpr int BK = D <= 64 ? 64 : 32;   // keys per tile
  static constexpr int LDS = D + 4;              // Q/K/V row stride
  static constexpr int LDP = BK + 4;             // P row stride
  static constexpr int CN = BK / 16;             // score columns / thread
  static constexpr int VW = D >= 64 ? 4 : 2;     // output vector width
  static constexpr int NJ = D / (16 * VW);       // output vectors / row
  static constexpr int DC = VW * NJ;             // output columns / thread
  static constexpr size_t kSmem =
      sizeof(float) * (size_t)(kBQ * LDS + 2 * BK * LDS + kBQ * LDP);
};

// rows [0, nrows) of a (rows, D) matrix into shared memory as float32
// with row stride LDS; rows >= valid are zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int nrows, int valid) {
  constexpr int V = D / 4;
  constexpr int LDS = Tiles<D>::LDS;
  for (int e = threadIdx.x; e < nrows * V; e += kThreads) {
    const int r = e / V;
    const int c = (e - r * V) * 4;
    const float4 f = r < valid ? load4(src + (size_t)r * D + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LDS + c) = f;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int S, int T_, int causal, int window,
                       float scale) {
  using C = Tiles<D>;
  constexpr int BK = C::BK, LDS = C::LDS, LDP = C::LDP, CN = C::CN;
  constexpr int VW = C::VW, NJ = C::NJ, DC = C::DC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LDS;
  float* Vs = Ks + BK * LDS;
  float* Ps = Vs + BK * LDS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid & 15;                 // key / output-column lane
  const int ty = tid >> 4;                 // owns query rows 4ty .. 4ty+3
  const T* qb = q + ((size_t)(b * H + h) * S + q0) * D;
  const T* kb = k + (size_t)(b * K + kh) * T_ * D;
  const T* vb = v + (size_t)(b * K + kh) * T_ * D;

  load_tile<D>(Qs, qb, kBQ, min(kBQ, S - q0));

  // key tiles that hold a key some query row of this tile may see
  const int q_last = min(S, q0 + kBQ) - 1;
  const int hi = causal ? min(T_, q_last + 1) : T_;
  int lo = window ? max(0, q0 - window + 1) : 0;
  lo = (lo / BK) * BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();                 // the last tile's K/V reads are done
    load_tile<D>(Ks, kb + (size_t)k0 * D, BK, min(BK, T_ - k0));
    load_tile<D>(Vs, vb + (size_t)k0 * D, BK, min(BK, T_ - k0));
    __syncthreads();

    float s[4][CN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], kk[CN];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LDS + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, kk[j].x, t);
          t = fmaf(a[i].y, kk[j].y, t);
          t = fmaf(a[i].z, kk[j].z, t);
          t = fmaf(a[i].w, kk[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      unsigned ok = 0;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool valid = kp < T_ && (!causal || kp <= qp)
                           && (!window || kp > qp - window);
        ok |= (unsigned)valid << j;
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(kFull, mc, off));
      const float mn = fmaxf(m[i], mc);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - mn) : 0.0f;
        Ps[(4 * ty + i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      const float alpha = m[i] <= kNegInf * 0.5f ? 0.0f : expf(m[i] - mn);
      l[i] = alpha * l[i] + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();                    // P rows come from this half-warp

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * LDS + tx * VW;
        float vv[DC];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          if constexpr (VW == 4) {
            const float4 t =
                *reinterpret_cast<const float4*>(vrow + jj * 16 * VW);
            vv[jj * 4 + 0] = t.x;
            vv[jj * 4 + 1] = t.y;
            vv[jj * 4 + 2] = t.z;
            vv[jj * 4 + 3] = t.w;
          } else {
            const float2 t =
                *reinterpret_cast<const float2*>(vrow + jj * 16 * VW);
            vv[jj * 2 + 0] = t.x;
            vv[jj * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0   ? p4[i].x
                          : cc == 1 ? p4[i].y
                          : cc == 2 ? p4[i].z
                                    : p4[i].w;
#pragma unroll
          for (int c2 = 0; c2 < DC; ++c2) acc[i][c2] = fmaf(p, vv[c2], acc[i][c2]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)(b * H + h) * S + qp) * D + tx * VW;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        store(orow + jj * 16 * VW + e, acc[i][jj * VW + e] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int K, int S, int T_, int causal,
                   int window, float scale, cudaStream_t s) {
  constexpr size_t smem = Tiles<D>::kSmem;
  auto kern = flash_attention_kernel<D, T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, S, T_, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int K, int S, int T_, int D, int causal,
                     int window, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<32, T>(q, k, v, out, B, H, K, S, T_, causal, window,
                           scale, s);
    case 64:
      return launch<64, T>(q, k, v, out, B, H, K, S, T_, causal, window,
                           scale, s);
    case 128:
      return launch<128, T>(q, k, v, out, B, H, K, S, T_, causal, window,
                            scale, s);
    case 256:
      return launch<256, T>(q, k, v, out, B, H, K, S, T_, causal, window,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of card `device`; returns a cudaError_t (0 on
// success). The wrapper has checked D in {32, 64, 128, 256}, H % K == 0,
// S >= 1, H and B <= 65535 (grid y and z), contiguity, alignment and the type
// (is_bf16: 0 float32, 1 bfloat16).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int K, int S, int T_,
                           int D, int causal, int window, float scale,
                           int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, B, H, K, S, T_, D,
                                        causal, window, scale, s)
              : dispatch<float>(q, k, v, out, B, H, K, S, T_, D, causal,
                                window, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
