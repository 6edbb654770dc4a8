// Paged flash-decode attention for NVIDIA Hopper (sm_90a), split over the
// keys (split-KV).
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
// bandwidth. At the served shapes that floor is ~2.6 us, below a
// launch's own latency, so the design aims at latency: many CTAs, each
// with a short dependent chain.
//   - Split pass, grid (split, kv head, row): split s of row b covers the
//     key positions [s*R, (s+1)*R), R a multiple of the 32-key tile,
//     chosen by the wrapper so that B*K*splits fills the SMs about twice.
//     A split wholly past pos[b] (or of a dead row) exits at once; the
//     combine does not read it.
//   - A tile is 32 consecutive key positions and may span pages: each key
//     row looks up its own page, so no tile is cut at a page edge. Rows
//     that are past pos, past the split or on a page mapped >= N are
//     zero-filled in shared memory and masked.
//   - K/V tiles arrive through a 3-stage ring of cp.async copies (16 B,
//     or 8 B for bf16 rows that are not whole 16-byte pieces): tiles i+1
//     and i+2 are in flight while tile i is computed, with one
//     __syncthreads per tile.
//   - Warp w owns query heads w, w+4, ... of the GQA group: it computes
//     their scores (8 lanes per key, each over D/8 of the dot, a 3-step
//     shuffle reduce), runs their online softmax with one key per lane,
//     and keeps acc for them in registers (lane owns d = lane + 32 e: 2,
//     4 or 8 values for D up to 64, 128 or 256). At D = 256 in float32 the
//     ring alone is 195 KiB, so the wrapper launches at most 27 query
//     heads per KV head at a time (a larger group is cut into pieces).
//   - Each split writes its partial (m, l, acc) in float32 to scratch the
//     wrapper allocates; a second small kernel (grid K x B) merges a
//     row's splits in split order, with the same alpha guard for a split
//     that saw no key, so results are deterministic from run to run. It
//     is launched with programmatic dependent launch: its CTAs are
//     scheduled while the split pass runs and wait for it in place
//     (griddepcontrol), which hides most of a second launch's latency.
// What bounds it now: latency, not bytes — a launch, the pos -> page map
// -> K/V load chain and the combine: about 17 us on an H100 at the
// served shapes, against a 2.5 us bandwidth floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTK = 32;        // keys per tile: one per lane in the softmax
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;     // K/V ring depth
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// four consecutive elements of a shared-memory row as floats
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

template <int PB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (PB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}
template <int PB>
__device__ __forceinline__ void zero_piece(void* dst) {
  if constexpr (PB == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// K/V row stride in shared memory, bytes: one 16-byte pad per row
__host__ __device__ __forceinline__ int row_bytes(int D, int esize) {
  return D * esize + 16;
}

// query heads per warp for G heads per KV head (the dispatch's GW)
int heads_per_warp(int G) {
  return G <= 4 ? 1 : G <= 8 ? 2 : G <= 16 ? 4 : 8;
}

size_t smem_bytes(int G, int D, int esize, int GW) {
  return sizeof(float) * (size_t)G * D                      // q
         + (size_t)kStages * 2 * kTK * row_bytes(D, esize)  // K/V ring
         + sizeof(float) * (size_t)kWarps * GW * kTK        // scores / p
         + (size_t)kStages * kTK;                           // key valid
}

// Issue the copies of tile `tile` of the split into ring slot `slot`:
// 4 threads per key row, each looking the row's page up once. Rows with
// no key (past `end`, or on a page mapped >= N) become zeros.
template <typename T, int PB>
__device__ __forceinline__ void issue_tile(
    const T* __restrict__ kpool, const T* __restrict__ vpool,
    const int* __restrict__ pm, unsigned char* ks, unsigned char* vs,
    unsigned char* ok, int start, int end, int tile, int ps, int N, int K,
    int kh, int D, int tid) {
  const int t = tid >> 2;
  const int sub = tid & 3;
  const int kp = start + tile * kTK + t;
  long long off = -1;
  if (kp < end) {
    const int j = kp / ps;
    const int pg = pm[j];
    if (pg < N)
      off = (((long long)max(pg, 0) * ps + (kp - j * ps)) * K + kh) * D;
  }
  const int rb = row_bytes(D, (int)sizeof(T));
  unsigned char* kd = ks + t * rb;
  unsigned char* vd = vs + t * rb;
  const int npieces = D * (int)sizeof(T) / PB;
  if (off >= 0) {
    const unsigned char* kg =
        reinterpret_cast<const unsigned char*>(kpool + off);
    const unsigned char* vg =
        reinterpret_cast<const unsigned char*>(vpool + off);
    for (int c = sub; c < npieces; c += 4) {
      cp_async<PB>(kd + c * PB, kg + c * PB);
      cp_async<PB>(vd + c * PB, vg + c * PB);
    }
  } else {
    for (int c = sub; c < npieces; c += 4) {
      zero_piece<PB>(kd + c * PB);
      zero_piece<PB>(vd + c * PB);
    }
  }
  if (sub == 0) ok[t] = off >= 0;
}

// GW: query heads per warp (G <= 4 * GW); DV: output values per lane
// (D <= 32 * DV); PB: bytes per cp.async piece.
template <typename T, int GW, int DV, int PB>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ kpool,
                              const T* __restrict__ vpool,
                              const int* __restrict__ page_map,
                              const int* __restrict__ pos_arr,
                              const int* __restrict__ live_arr,
                              float* __restrict__ part, int H, int K, int D,
                              int N, int ps, int P, int R, int S,
                              float scale) {
  // the combine may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int pos = pos_arr[b];
  const int start = split * R;
  if (live_arr[b] == 0 || start > pos) return;   // the combine skips it
  const int end = min(min(start + R, P * ps), pos + 1);  // keys [start, end)
  const int ntiles = (end - start + kTK - 1) / kTK;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rb = row_bytes(D, (int)sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                 // (G, D)
  unsigned char* ring = smem + sizeof(float) * (size_t)G * D;  // 16-aligned
  float* p_s = reinterpret_cast<float*>(ring + (size_t)kStages * 2 * kTK * rb);
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(
      p_s + kWarps * GW * kTK);                                // (stage, kTK)
  float* pw = p_s + warp * GW * kTK;                           // this warp's

  const int* pm = page_map + (size_t)b * P;
  auto kslot = [&](int s) { return ring + (size_t)s * 2 * kTK * rb; };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles)
      issue_tile<T, PB>(kpool, vpool, pm, kslot(i), kslot(i) + kTK * rb,
                        ok_s + i * kTK, start, end, i, ps, N, K, kh, D, tid);
    cp_async_commit();
  }
  // heads kh*G .. kh*G+G-1 of row b are contiguous: (G, D)
  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f32(qb[i]);

  float m[GW], l[GW], acc[GW][DV];
#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[gi][e] = 0.f;
  }
  const int grp = lane >> 3;   // this lane's key within a group of 4
  const int l8 = lane & 7;     // its share of the D-dot
  const int nchunks = D / 4;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile it landed for all; tile it-1 is done with
    {
      const int nx = it + kStages - 1;
      if (nx < ntiles) {
        const int s = nx % kStages;
        issue_tile<T, PB>(kpool, vpool, pm, kslot(s), kslot(s) + kTK * rb,
                          ok_s + s * kTK, start, end, nx, ps, N, K, kh, D,
                          tid);
      }
      cp_async_commit();
    }
    const int slot = it % kStages;
    const unsigned char* kt = kslot(slot);
    const unsigned char* vt = kt + kTK * rb;

    // scores of this warp's heads: 8 lanes per key, 4 keys at a time
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      const int g = warp + kWarps * gi;
      if (g < G) {
        const float* qg = q_s + g * D;
#pragma unroll 2
        for (int kk = 0; kk < kTK / 4; ++kk) {
          const int t = kk * 4 + grp;
          const T* krow = reinterpret_cast<const T*>(kt + t * rb);
          float dot = 0.f;
          for (int c = l8; c < nchunks; c += 8) {
            const float4 kv = load4(krow + 4 * c);
            const float4 qv = *reinterpret_cast<const float4*>(qg + 4 * c);
            dot = fmaf(qv.x, kv.x, dot);
            dot = fmaf(qv.y, kv.y, dot);
            dot = fmaf(qv.z, kv.z, dot);
            dot = fmaf(qv.w, kv.w, dot);
          }
          dot += __shfl_xor_sync(kFull, dot, 1);
          dot += __shfl_xor_sync(kFull, dot, 2);
          dot += __shfl_xor_sync(kFull, dot, 4);
          if (l8 == 0) pw[gi * kTK + t] = dot;
        }
      }
    }
    __syncwarp();
    // online softmax, one key per lane
    const bool valid = ok_s[slot * kTK + lane] != 0;
#pragma unroll
    for (int gi = 0; gi < GW; ++gi) {
      const int g = warp + kWarps * gi;
      if (g < G) {
        const float s = valid ? pw[gi * kTK + lane] * scale : kNegInf;
        const float mn = fmaxf(m[gi], warp_max(s));
        const float p = valid ? expf(s - mn) : 0.f;
        const float alpha = m[gi] <= kNegInf * 0.5f ? 0.f : expf(m[gi] - mn);
        l[gi] = alpha * l[gi] + warp_sum(p);
        m[gi] = mn;
        pw[gi * kTK + lane] = p;
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[gi][e] *= alpha;
      }
    }
    __syncwarp();
    // acc += p V, lane owns d = lane + 32 e
#pragma unroll 4
    for (int t = 0; t < kTK; ++t) {
      const T* vrow = reinterpret_cast<const T*>(vt + t * rb);
      float vv[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < D ? to_f32(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GW; ++gi) {
        if (warp + kWarps * gi < G) {
          const float p = pw[gi * kTK + t];
#pragma unroll
          for (int e = 0; e < DV; ++e) acc[gi][e] = fmaf(p, vv[e], acc[gi][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // partial of this split: part = m (B,K,S,G) | l (B,K,S,G) | acc (..,D)
  const size_t n_ml = (size_t)gridDim.z * K * S * G;
  const size_t row = ((size_t)b * K + kh) * S + split;
#pragma unroll
  for (int gi = 0; gi < GW; ++gi) {
    const int g = warp + kWarps * gi;
    if (g < G) {
      const size_t i = row * G + g;
      if (lane == 0) {
        part[i] = m[gi];
        part[n_ml + i] = l[gi];
      }
      float* pa = part + 2 * n_ml + i * D;
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        const int d = lane + 32 * e;
        if (d < D) pa[d] = acc[gi][e];
      }
    }
  }
}

// Merge the splits of (row b, kv head kh) in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine_kernel(const float* __restrict__ part,
                                const int* __restrict__ pos_arr,
                                const int* __restrict__ live_arr,
                                T* __restrict__ out, int B, int H, int K,
                                int D, int R, int S) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int pos = pos_arr[b];
  // launched early (programmatic dependent launch): wait for the split
  // pass to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // splits the split pass wrote: those that start at or before pos
  const int ns = (live_arr[b] != 0 && pos >= 0) ? min(S, pos / R + 1) : 0;
  const size_t n_ml = (size_t)B * K * S * G;
  const size_t row0 = ((size_t)b * K + kh) * S;
  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    float M = kNegInf;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) M = fmaxf(M, part[(row0 + s) * G + g]);
    float L = 0.f, o = 0.f;
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const size_t j = (row0 + s) * G + g;
      const float ms = part[j];
      if (ms <= kNegInf * 0.5f) continue;   // a split that saw no key
      const float w = expf(ms - M);
      L = fmaf(w, part[n_ml + j], L);
      o = fmaf(w, part[2 * n_ml + j * D + d], o);
    }
    store(ob + i, o / fmaxf(L, 1e-30f));
  }
}

template <typename T, int GW, int DV, int PB>
cudaError_t launch_split(const void* q, const void* kpool, const void* vpool,
                         const void* page_map, const void* pos,
                         const void* live, float* part, int B, int H, int K,
                         int D, int N, int ps, int P, int R, int S,
                         float scale, cudaStream_t s) {
  auto kern = flash_decode_split_kernel<T, GW, DV, PB>;
  const int smem = (int)smem_bytes(H / K, D, (int)sizeof(T), GW);
  // the shared-memory limit is raised once per instantiation and card, to
  // the largest size asked for so far: the wrapper runs once per layer of
  // every decode step, and that step is bound by the host
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev >= kMaxDevices || smem > allowed[dev].load()) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    if (dev < kMaxDevices) allowed[dev].store(smem);
  }
  kern<<<dim3(S, K, B), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(page_map),
      static_cast<const int*>(pos), static_cast<const int*>(live), part, H,
      K, D, N, ps, P, R, S, scale);
  return cudaGetLastError();
}

template <typename T, int GW, int DV>
cudaError_t dispatch_pb(bool whole16, const void* q, const void* kpool,
                        const void* vpool, const void* page_map,
                        const void* pos, const void* live, float* part, int B,
                        int H, int K, int D, int N, int ps, int P, int R,
                        int S, float scale, cudaStream_t s) {
  if (whole16)
    return launch_split<T, GW, DV, 16>(q, kpool, vpool, page_map, pos, live,
                                       part, B, H, K, D, N, ps, P, R, S,
                                       scale, s);
  return launch_split<T, GW, DV, 8>(q, kpool, vpool, page_map, pos, live,
                                    part, B, H, K, D, N, ps, P, R, S, scale,
                                    s);
}

template <typename T, int GW>
cudaError_t dispatch_dv(bool whole16, const void* q, const void* kpool,
                        const void* vpool, const void* page_map,
                        const void* pos, const void* live, float* part, int B,
                        int H, int K, int D, int N, int ps, int P, int R,
                        int S, float scale, cudaStream_t s) {
  if (D <= 64)
    return dispatch_pb<T, GW, 2>(whole16, q, kpool, vpool, page_map, pos,
                                 live, part, B, H, K, D, N, ps, P, R, S,
                                 scale, s);
  if (D <= 128)
    return dispatch_pb<T, GW, 4>(whole16, q, kpool, vpool, page_map, pos,
                                 live, part, B, H, K, D, N, ps, P, R, S,
                                 scale, s);
  return dispatch_pb<T, GW, 8>(whole16, q, kpool, vpool, page_map, pos, live,
                               part, B, H, K, D, N, ps, P, R, S, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* kpool, const void* vpool,
                     const void* page_map, const void* pos, const void* live,
                     void* out, float* part, int B, int H, int K, int D,
                     int N, int ps, int P, int R, int S, float scale,
                     cudaStream_t s) {
  const int G = H / K;
  // 16-byte copies need whole 16-byte rows and 16-byte aligned pools
  const bool whole16 =
      (D * (int)sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(kpool) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(vpool) % 16 == 0;
  cudaError_t err = cudaSuccess;
  if (S > 0) {   // else no key position at all: the combine writes zeros
    if (G <= 4)
      err = dispatch_dv<T, 1>(whole16, q, kpool, vpool, page_map, pos, live,
                              part, B, H, K, D, N, ps, P, R, S, scale, s);
    else if (G <= 8)
      err = dispatch_dv<T, 2>(whole16, q, kpool, vpool, page_map, pos, live,
                              part, B, H, K, D, N, ps, P, R, S, scale, s);
    else if (G <= 16)
      err = dispatch_dv<T, 4>(whole16, q, kpool, vpool, page_map, pos, live,
                              part, B, H, K, D, N, ps, P, R, S, scale, s);
    else
      err = dispatch_dv<T, 8>(whole16, q, kpool, vpool, page_map, pos, live,
                              part, B, H, K, D, N, ps, P, R, S, scale, s);
  }
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the combine's CTAs are scheduled while
  // the split pass runs and wait for it inside (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<T>,
                            static_cast<const float*>(part),
                            static_cast<const int*>(pos),
                            static_cast<const int*>(live),
                            static_cast<T*>(out), B, H, K, D, R, S);
}

}  // namespace

extern "C" {

// Keys per tile: the wrapper's split length R must be a multiple of it.
int flash_decode_tile_keys() { return kTK; }

// Dynamic shared memory of the split pass at G query heads per KV head,
// head dim D and `esize`-byte K/V values.
long long flash_decode_smem_bytes(int G, int D, int esize) {
  return (long long)smem_bytes(G, D, esize, heads_per_warp(G));
}

// Launch the split pass and the combine on `stream` of card `device`;
// returns cudaGetLastError() (0 on success). `part` is float32 scratch of
// B*K*S*G*(D+2) values, S = ceil(P*ps / R). The wrapper has checked the
// shapes, G = H/K <= 32 with the split pass within shared memory,
// D % 4 == 0 and D <= 256, B and K <= 65535, 8-byte aligned pools and R a
// positive multiple of the tile.
int flash_decode_launch(const void* q, const void* kpool, const void* vpool,
                        const void* page_map, const void* pos,
                        const void* live, void* out, void* part, int B,
                        int H, int K, int D, int N, int ps, int P, int R,
                        float scale, int is_bf16, int device, void* stream) {
  if (B == 0) return 0;
  // run on `device` and leave the caller's current card as it was
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S = (P * ps + R - 1) / R;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  err = is_bf16 ? dispatch<__nv_bfloat16>(q, kpool, vpool, page_map, pos,
                                          live, out, pt, B, H, K, D, N, ps, P,
                                          R, S, scale, s)
                : dispatch<float>(q, kpool, vpool, page_map, pos, live, out,
                                  pt, B, H, K, D, N, ps, P, R, S, scale, s);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // extern "C"
