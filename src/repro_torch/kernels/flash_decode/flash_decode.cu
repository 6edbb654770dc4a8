// Paged flash-decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_decode_kernel`
// (src/repro/kernels/flash_decode/flash_decode.py, launched by
// `flash_decode_pallas`): single-token ragged GQA decode attention read
// directly off the paged KV pool through a page map.
//
//   q        (B, H, D)        query of each row's current token
//   kpool    (N, ps, K, D)    one layer's K pages; vpool the same for V
//   page_map (B, P) int32     row b's ordered page ids; >= N means no page
//   pos      (B,)   int32     last valid position of each row
//   live     (B,)   int32     row mask; dead rows give exact zeros
//   out      (B, H, D)        in q's type; accumulation is float32
//
// Semantics kept from the TPU kernel: pages mapped >= N, pages past
// pos[b] / ps and dead rows are skipped; keys past pos[b] are masked;
// online softmax in float32 with scale D^-0.5, NEG_INF = -1e30, the
// alpha guard for a running max still at NEG_INF, and a max(l, 1e-30)
// denominator (which turns a row that saw no key into exact zeros).
//
// What bounds it on the card: bytes. Each live token costs 2*K*D values
// of K/V per layer and a handful of flops per byte, far below the
// H100's ops:bytes balance, so the floor is the live K/V bytes over HBM
// bandwidth. The design is simple rather than fast:
//   - one CTA per (row b, kv head kh) computes that head's G = H/K query
//     heads, so the K/V of a page is read from device memory once for
//     the whole GQA group;
//   - the CTA walks the row's pages in order (the TPU grid's sequential
//     page axis becomes a loop) in tiles of up to 32 keys; tiles wholly
//     past pos[b] are skipped, which is exact because they would leave
//     m, l and acc as they are;
//   - a tile's K and V rows arrive as 16-byte vector loads into
//     registers, all issued at once, and the NEXT tile's loads are
//     issued before the current tile is computed, so one memory latency
//     hides behind one tile's arithmetic instead of one per element;
//   - scores use one warp per (head, 32 keys) tile with a padded K row
//     stride (no bank conflicts), the softmax update is one warp per
//     query head with shuffles, and acc lives in shared memory.
// Split-KV across CTAs and TMA/wgmma are the next steps: with B*K CTAs
// (64 at the served shapes) the card is far from full, and the longest
// row sets the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;      // keys per shared-memory tile (== warp size)
constexpr int kThreads = 128;
constexpr int kMaxD = 128;
// 4-element vector loads per thread for one tile of K (or V)
constexpr int kLoads = kTile * kMaxD / (4 * kThreads);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// Advance (j, t0) to the next tile the row reads: a page j with a real
// page id (< N) whose keys t0.. are not all past pos. Returns false when
// the row has no more tiles. Block-uniform: every thread gets the same.
__device__ __forceinline__ bool next_tile(const int* __restrict__ pm, int P,
                                          int N, int ps, int pos, int& j,
                                          int& t0, int& page) {
  for (; j < P && j * ps <= pos; ++j, t0 = 0) {
    if (t0 >= ps || j * ps + t0 > pos) continue;
    const int pg = pm[j];
    if (pg < N) {
      page = max(pg, 0);
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_floats(int G, int D) {
  // q (G*D) + acc (G*D) + K tile (kTile*(D+1)) + V tile (kTile*D)
  // + probabilities (G*kTile) + m, l, alpha (3*G)
  return 2 * (size_t)G * D + (size_t)kTile * (D + 1) + (size_t)kTile * D +
         (size_t)G * kTile + 3 * (size_t)G;
}

// Issue every 4-element vector load of K and V for the tile of keys
// t0 .. t0+nt-1 of `page` (kv head kh) before any of them is used;
// returns nt. Thread tid takes vectors tid, tid+kThreads, ...
template <typename T>
__device__ __forceinline__ int load_tile(const T* __restrict__ kpool,
                                         const T* __restrict__ vpool,
                                         float4 (&kr)[kLoads],
                                         float4 (&vr)[kLoads], int page,
                                         int t0, int ps, int K, int kh, int D,
                                         int tid) {
  const int nt = min(kTile, ps - t0);
  const int nvec = D / 4;
  const size_t row0 = ((size_t)page * ps + t0) * K + kh;
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int v = tid + r * kThreads;
    if (v < nt * nvec) {
      const int t = v / nvec;
      const size_t off = (row0 + (size_t)t * K) * D + (v - t * nvec) * 4;
      kr[r] = load4(kpool + off);
      vr[r] = load4(vpool + off);
    }
  }
  return nt;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ page_map,
                        const int* __restrict__ pos_arr,
                        const int* __restrict__ live_arr, T* __restrict__ out,
                        int H, int K, int D, int N, int ps, int P,
                        float scale) {
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int KS = D + 1;  // padded K row stride: score reads hit distinct banks

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // (G, D)
  float* acc_s = q_s + G * D;     // (G, D)
  float* k_s = acc_s + G * D;     // (kTile, D+1)
  float* v_s = k_s + kTile * KS;  // (kTile, D)
  float* p_s = v_s + kTile * D;   // (G, kTile) scores, then probabilities
  float* m_s = p_s + G * kTile;   // (G,) running max
  float* l_s = m_s + G;           // (G,) running denominator
  float* a_s = l_s + G;           // (G,) this tile's rescale factor

  // heads kh*G .. kh*G+G-1 of row b are contiguous: (G, D)
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int pos = pos_arr[b];
  const int* pm = page_map + (size_t)b * P;
  const int nvec = D / 4;  // vectors per key row
  int j = 0, t0 = 0, page = 0, nt = 0;
  bool have = live_arr[b] != 0 && next_tile(pm, P, N, ps, pos, j, t0, page);
  float4 kr[kLoads], vr[kLoads];
  if (have) nt = load_tile(kpool, vpool, kr, vr, page, t0, ps, K, kh, D, tid);
  while (have) {
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int v = tid + r * kThreads;
      if (v < nt * nvec) {
        const int t = v / nvec;
        const int d = (v - t * nvec) * 4;
        float* kd = k_s + t * KS + d;
        kd[0] = kr[r].x; kd[1] = kr[r].y; kd[2] = kr[r].z; kd[3] = kr[r].w;
        *reinterpret_cast<float4*>(v_s + t * D + d) = vr[r];
      }
    }
    __syncthreads();
    const int base = j * ps + t0;  // first key position of this tile
    const int cur = nt;
    t0 += kTile;                   // prefetch the next tile's K/V
    have = next_tile(pm, P, N, ps, pos, j, t0, page);
    if (have) nt = load_tile(kpool, vpool, kr, vr, page, t0, ps, K, kh, D, tid);
    for (int i = tid; i < G * kTile; i += blockDim.x) {
      const int g = i / kTile;
      const int t = i - g * kTile;
      float s = kNegInf;
      if (t < cur && base + t <= pos) {
        const float* qg = q_s + g * D;
        const float* kt = k_s + t * KS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kt[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      const bool valid = lane < cur && base + lane <= pos;
      const float s = p_s[g * kTile + lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      p_s[g * kTile + lane] = p;
      const float psum = warp_sum(p);
      const float alpha = m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_new);
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += blockDim.x) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = p_s + g * kTile;
      float a = a_s[g] * acc_s[i];
      for (int t = 0; t < cur; ++t) a = fmaf(pg[t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }
  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    store(ob + i, acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper checks it against
// the 48 KB a launch gets without opting in to more).
long long flash_decode_smem_bytes(int H, int K, int D) {
  return (long long)(smem_floats(H / K, D) * sizeof(float));
}

// Launch on `stream` of card `device`; returns cudaGetLastError() (0 on
// success).
int flash_decode_launch(const void* q, const void* kpool, const void* vpool,
                        const void* page_map, const void* pos,
                        const void* live, void* out, int B, int H, int K,
                        int D, int N, int ps, int P, float scale, int is_bf16,
                        int device, void* stream) {
  if (B == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const size_t smem = smem_floats(H / K, D) * sizeof(float);
  const dim3 grid(B, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    flash_decode_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(kpool),
        static_cast<const T*>(vpool), static_cast<const int*>(page_map),
        static_cast<const int*>(pos), static_cast<const int*>(live),
        static_cast<T*>(out), H, K, D, N, ps, P, scale);
  } else {
    flash_decode_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kpool),
        static_cast<const float*>(vpool), static_cast<const int*>(page_map),
        static_cast<const int*>(pos), static_cast<const int*>(live),
        static_cast<float*>(out), H, K, D, N, ps, P, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
