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
// dt * A[h] inside the chunk:
//   seg = min(cum_i - cum_j, 0)          clamped BEFORE exp, as the TPU
//                                        kernel does (j > i would overflow)
//   G   = (C B^T) * exp(seg) * dt_j      for j <= i, else 0
//   y   = G x + exp(cum_i) * (C h^T)     h: the (hd, N) state entering
//   h  <- h * exp(cum_Q) + S_c,  S_c = sum_j dt_j exp(cum_Q - cum_j) x_j B_j^T
// The chunk is Q <= 128 steps, any length (the wrapper passes
// min(chunk, S)); steps past S in the last chunk read as dt = 0, x = B =
// C = 0 (no decay, no input), which is what the JAX wrapper's zero
// padding gives, and their y is not written: no padded copy.
//
// The design: the SSD "hardware-efficient" decomposition of the Mamba2
// paper (arXiv:2405.21060, section 6), three kernels in stream order:
//   (a) chunk_state_kernel, one CTA per (chunk, group of heads, b): the
//       in-chunk cumsum of dt * A for every head of the group up front, a
//       warp-shuffle scan (written out with dt for (b) and (c)); then per
//       head S_c = (x w)^T B, w_j = dt_j exp(cum_Q - cum_j), for every
//       chunk but the last, as wgmma: B^T split once per CTA into TF32
//       planes in shared memory, A = (x w)^T split in registers. One more
//       CTA per (chunk, b) computes C B^T ONCE for all heads (g = 1), on
//       mma.sync, and writes it and C's TF32 planes in the register
//       layout (c) reads them in;
//   (b) state_pass_kernel, one thread per 4 entries of a (b, head) state:
//       the only sequential part, h_c = h_{c-1} exp(cum_Q) + S_{c-1},
//       elementwise over hd x N, overwriting each S_c in place with the
//       state that enters chunk c;
//   (c) chunk_scan_kernel, one CTA per (chunk, group of heads, b): per
//       unit of 64 head columns, the entering state's and x's planes are
//       split once into shared memory, then C h^T (A = C's planes in
//       registers) and G x (A = G, computed per warp from C B^T, cum and
//       dt) run as wgmma, y = G x + exp(cum_i) C h^T.
// The independent work runs over B x chunks x heads tiles (3072 at B 4, S
// 2048, 48 heads; 768 at B 1), and the wrapper picks the group size so
// the waves over the 132 SMs come out even.
//
// What bounds it: the four products (C B^T, G x, C h^T, (x w)^T B) are
// 16.3 GFLOP at mamba2-780m's widths (B 4, S 2048, nh 48, hd 64, N 128)
// against 211 MB of input and output. All four run on the tensor cores
// as 3xTF32: each operand x is split into big = tf32(x) and small =
// tf32(x - big) (cvt.rna.tf32.f32), and big*big + big*small + small*big
// are TF32 products with float32 accumulation, which keeps about
// float32's accuracy (plain TF32 misses the scan's tolerance 5x). That is
// 3 x 16.3 GFLOP at 495 TFLOP/s = 98.6 us, above the bytes' 63 us. What
// holds it back on the card: the splits, G's exps and the per-head
// staging run on the ALUs between barriers, beside the products rather
// than under them; mma.sync (C B^T) peaks at 65% of wgmma's rate.
//
// Intermediate traffic (the reckoning behind three kernels): the chunk
// states are B * nc * nh * hd * N floats, 100.7 MB at B 4 (twice L2's 50
// MB); (a) writes them, (b) reads and rewrites them, (c) reads them:
// ~400 MB, ~120 us at 3.35 TB/s, beside 63 us of inputs and outputs.
// bf16 states would break the tolerance. Fusing (a) and (b) with a
// chunk-to-chunk hand-over between CTAs saves ~200 MB but needs a
// deadlock-free ordering (a ticket counter zeroed per launch); it is left
// for later. C B^T (4 MB), C's planes (8 MB) and cum / dt (3 MB) stay in
// L2. The states' buffer is cut into windows of chunks (at most 512 MiB
// of workspace, the state carried from window to window), so a short
// chunk at a long S does not need O(S) memory.
//
// Layouts (mma.sync.m16n8k8 fragments, PTX ISA, and wgmma's A in
// registers, per warp; g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g+8,
// t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g);
// accumulator c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1). C
// B^T is stored per lane as (c0, c2, c1, c3): read as an A fragment whose
// k index t means column 2t and t+4 column 2t+1, with x's columns stored
// in that order. wgmma's B operands are K-major with the 128-byte
// swizzle. Every branch around a wgmma is uniform over the CTA: a branch
// on the warp makes the compiler serialize the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kMaxGroup = 8;                     // heads per CTA at most
constexpr long long kWorkspaceCap = 128ll << 20;  // floats (512 MiB)
constexpr int kSmemBlock = 232448;              // one CTA's shared memory
                                                // at most (H100)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }
__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [0, nrows) x columns [0, ncols) of a row-major source (row stride
// `stride` elements) into shared memory as float32 (row stride ld); rows
// >= valid read as zeros. float32 goes through cp.async (commit and wait
// are the caller's), bfloat16 through registers.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t stride, int nrows, int valid,
                                          int ncols) {
  const int ppr = ncols / 4;
  for (int e = threadIdx.x; e < nrows * ppr; e += blockDim.x) {
    const int r = e / ppr;
    const int c = (e - r * ppr) * 4;
    const bool ok = r < valid;
    if constexpr (sizeof(T) == 4) {
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src,
                 ok ? 16 : 0);
    } else {
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          ok ? load4(src + r * stride + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ---- 3xTF32 on mma.sync ----------------------------------------------------
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
struct Split {
  uint32_t big, small;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t b = tf32(x);
  return {b, tf32(x - __uint_as_float(b))};
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// acc[n] += a b[n] over column tiles n < nn (of NT) in 3xTF32: the small
// terms first, each of the three products issued for every tile before
// the next, so that no product waits on the one before it in its tile
template <int NT>
__device__ __forceinline__ void mma3(float (&c)[NT][4], const Split (&a)[4],
                                     const Split (&b)[NT][2], int nn = NT) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nn)
      mma_tf32(c[n], a[0].small, a[1].small, a[2].small, a[3].small,
               b[n][0].big, b[n][1].big);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nn)
      mma_tf32(c[n], a[0].big, a[1].big, a[2].big, a[3].big, b[n][0].small,
               b[n][1].small);
#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (n < nn)
      mma_tf32(c[n], a[0].big, a[1].big, a[2].big, a[3].big, b[n][0].big,
               b[n][1].big);
}

// rows [0, nrows) x columns [0, ncols8) of a row-major source (row stride
// `stride` elements) into shared memory as TF32 planes: {big, small} pairs,
// row stride ld2 pairs. Rows >= valid and columns >= ncols read as zeros
// (ncols a multiple of 4). The source may be global or shared memory.
template <typename T>
__device__ __forceinline__ void split_tile(uint2* dst, int ld2, const T* src,
                                           size_t stride, int nrows,
                                           int valid, int ncols,
                                           int ncols8) {
  const int ppr = ncols8 / 4;
  for (int e = threadIdx.x; e < nrows * ppr; e += blockDim.x) {
    const int r = e / ppr;
    const int c = (e - r * ppr) * 4;
    const float4 v = r < valid && c < ncols
                         ? load4(src + r * stride + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const Split a = split(v.x), b = split(v.y), z = split(v.z),
                w = split(v.w);
    uint4* d = reinterpret_cast<uint4*>(dst + r * ld2 + c);
    d[0] = make_uint4(a.big, a.small, b.big, b.small);
    d[1] = make_uint4(z.big, z.small, w.big, w.small);
  }
}

// ---- wgmma (tf32, m64n64k8, A from registers) -----------------------------
// B in shared memory is K-major TF32 with the 128-byte swizzle: blocks of
// 32 columns (128 bytes a row), 8-row atoms of 1024 bytes in which row r's
// 16-byte chunk c sits at chunk c ^ (r % 8). Byte offset of (row r,
// column k < 32) in such a block:
__device__ __forceinline__ int swz128(int r, int k) {
  return (r >> 3) * 1024 + (r & 7) * 128 + (((k >> 2) ^ (r & 7)) << 4)
         + (k & 3) * 4;
}
// descriptor: start address, leading byte offset 16 (unused with the
// swizzle), stride byte offset 1024 (the next 8 rows), 128B swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared memory written by the threads made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// accumulators are written asynchronously: pin them after the wait
__device__ __forceinline__ void fence_regs(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
// d (64 x 32) += A (64 x 8, registers: each warp's 16 rows as in
// mma.m16n8k8) B (32 x 8)^T from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 64) += A (64 x 8, registers: each warp's 16 rows as in
// mma.m16n8k8) B (64 x 8)^T from shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- geometry shared by host and device ------------------------------------
// Q16: the chunk padded to whole 16-row tiles; N8: the state padded to
// whole k-steps of 8 (pad columns hold zeros); PC: the head columns one
// unit of (c) covers. Operands that several warps read are split once per
// CTA into TF32 planes.
struct Geo {
  int Q16, N8, PC;
  int ldb2;    // (a), C B^T: B planes, Q16 rows
  int ldx;     // (a): x as float32, Q16 rows, per buffer
  int nbj;     // (a): B^T's planes, N8 rows, nbj blocks of 32 steps
  int slack;   // (a): bytes after them that the last 64-column job reads
               // past row N8 (into columns it does not store)
  int nbk;     // (c): blocks of 32 columns of the planes (the state's
               // N8, then x's Q16)
};
__host__ __device__ __forceinline__ Geo geometry(int Q, int N, int hd) {
  Geo g;
  g.Q16 = round16(Q);
  g.N8 = round8(N);
  g.PC = hd < 64 ? hd : 64;
  g.ldb2 = g.N8 + 4;
  g.ldx = hd + 8;
  g.nbj = (g.Q16 + 31) / 32;
  g.slack = ((g.N8 + 63) / 64 * 64 - g.N8) * 128;
  g.nbk = ((g.N8 > g.Q16 ? g.N8 : g.Q16) + 31) / 32;
  return g;
}
// (a), bytes: the C B^T CTA's B planes; a heads CTA's 1024 to align,
// B^T's planes, nbuf x tiles, cum / dt / w of its heads and the warps'
// sums; the larger of the two
__host__ __device__ __forceinline__ long long state_smem_bytes(const Geo& g,
                                                               int nbuf) {
  const long long cbs = 8ll * g.Q16 * g.ldb2;
  const long long heads = 1024 + 2ll * g.nbj * g.N8 * 128 + g.slack
                          + 4ll * nbuf * g.Q16 * g.ldx
                          + 4ll * (3 * kMaxGroup * g.Q16 + kWarps);
  return cbs > heads ? cbs : heads;
}
// (c), bytes: 1024 to align, the planes, C B^T's fragments (row tile w:
// 2w + 2 k-steps), cum / dt; staged adds the next unit's state, x and
// cum / dt as float32 (cp.async lands them during a unit)
__host__ __device__ __forceinline__ long long scan_smem_bytes(const Geo& g,
                                                              int staged) {
  const long long nrt = g.Q16 / 16;
  return 1024 + 2ll * g.nbk * g.PC * 128 + 512 * nrt * (nrt + 1)
         + 8ll * g.Q16
         + (staged ? 4ll * ((long long)g.Q16 * g.PC
                            + (long long)g.PC * g.N8 + 2 * g.Q16)
                   : 0);
}

// ---- (a) chunk states, cum and dt, and C B^T --------------------------------
// grid (chunks of the window, head groups + 1, B). Workspace, per window:
// cv [B][nh][nwc][2 Q16] (cum, then dt), cb [B][nwc][Q16 Q16] (C B^T in
// the A-fragment layout (c) reads), cf [B][nwc][Q16 N8 2] (C's TF32
// planes, same layout), st [B][nh][nwc][hd N] (the states).
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, 1)
chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, float* __restrict__ cv,
                   float* __restrict__ cb, uint32_t* __restrict__ cf,
                   float* __restrict__ st, int S, int nh, int N, int Q,
                   int nc, int c0, int nwc, int hg, int nbuf) {
  const int cw = blockIdx.x;
  const int c = c0 + cw;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Geo geo = geometry(Q, N, HD);
  const int Q16 = geo.Q16, N8 = geo.N8, LDB2 = geo.ldb2, LDX = geo.ldx;
  const int s0 = c * Q;
  const int valid = min(Q, S - s0);
  const bool cb_cta = grp == (int)gridDim.y - 1;
  const bool states = !cb_cta && c < nc - 1;   // the last chunk's S_c is
                                               // never read

  // the C B^T CTA: B as planes of {big, small} pairs, B[j][n]. A heads
  // CTA: B^T (row n, K = j) as two 128B-swizzled TF32 planes for wgmma
  // (1024-byte aligned), then x and the heads' vectors
  extern __shared__ float4 smem4[];
  uint2* Bp = reinterpret_cast<uint2*>(smem4);   // Q16 x LDB2
  char* Bt = reinterpret_cast<char*>(smem4);
  Bt += (1024 - (smem_u32(Bt) & 1023)) & 1023;
  const int NBJ = geo.nbj;
  const int bts = NBJ * N8 * 128;                // bytes per plane
  float* Xs = reinterpret_cast<float*>(Bt + 2 * bts + geo.slack);
                                                 // nbuf x Q16 x LDX
  float* cum = Xs + nbuf * Q16 * LDX;            // hg x Q16 each
  float* dts = cum + kMaxGroup * Q16;
  float* wv = dts + kMaxGroup * Q16;
  float* wsum = wv + kMaxGroup * Q16;            // kWarps

  const int h_lo = grp * hg;
  const int h_hi = min(nh, h_lo + hg);
  const size_t xstep = (size_t)nh * HD;          // x's stride per step
  auto load_x = [&](int h, int buf) {
    load_tile(Xs + buf * Q16 * LDX, LDX,
              x + (((size_t)b * S + s0) * nh + h) * HD, xstep, Q16, valid,
              HD);
    cp_async_commit();
  };
  if (states && nbuf == 2) load_x(h_lo, 0);      // lands while B is split
  if (cb_cta)
    split_tile(Bp, LDB2, Bm + ((size_t)b * S + s0) * N, (size_t)N, Q16,
               valid, N, N8);
  if (states) {
    // B^T's planes: rows n < N8 (zeros past N), columns j < Q16 (zeros
    // past the chunk); a warp writes 32 steps j of the same rows, which
    // the swizzle spreads over all 32 banks
    const T* Bb = Bm + ((size_t)b * S + s0) * N;
    for (int e = tid; e < 128 * (N8 / 4); e += kThreads) {
      const int j = e & 127, n4 = (e >> 7) * 4;
      if (j >= Q16) continue;
      const float4 v = j < valid && n4 < N ? load4(Bb + (size_t)j * N + n4)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      const float vals[4] = {v.x, v.y, v.z, v.w};
      const int blk = (j >> 5) * N8 * 128;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Split sp = split(vals[i]);
        const int off = blk + swz128(n4 + i, j & 31);
        *reinterpret_cast<uint32_t*>(Bt + off) = sp.big;
        *reinterpret_cast<uint32_t*>(Bt + bts + off) = sp.small;
      }
    }
    fence_proxy_async();     // written by the threads, read by wgmma
  }

  if (cb_cta) {
    // C B^T for (b, c): warp w computes row tile w, columns up to its
    // diagonal, with C's fragments read from global memory and written
    // back as TF32 planes for (c)
    __syncthreads();
    const int nrt = Q16 / 16;
    if (warp >= nrt) return;
    const int r0 = 16 * warp;
    const int ntn = 2 * warp + 2;                // column tiles needed
    const T* Cb = Cm + ((size_t)b * S + s0) * N;
    uint4* cfo = reinterpret_cast<uint4*>(
                     cf + ((size_t)b * nwc + cw) * Q16 * N8 * 2)
                 + (size_t)warp * (N8 / 8) * 64 + 2 * lane;
    const int ra = r0 + g, rb = ra + 8;
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int k0 = 0; k0 < N8; k0 += 8) {
      const int n0 = k0 + t, n1 = n0 + 4;
      const bool okn1 = n1 < N;
      const Split a[4] = {
          split(ra < valid ? to_f32(Cb[(size_t)ra * N + n0]) : 0.f),
          split(rb < valid ? to_f32(Cb[(size_t)rb * N + n0]) : 0.f),
          split(ra < valid && okn1 ? to_f32(Cb[(size_t)ra * N + n1]) : 0.f),
          split(rb < valid && okn1 ? to_f32(Cb[(size_t)rb * N + n1]) : 0.f)};
      cfo[(k0 / 8) * 64] = make_uint4(a[0].big, a[1].big, a[2].big, a[3].big);
      cfo[(k0 / 8) * 64 + 1] =
          make_uint4(a[0].small, a[1].small, a[2].small, a[3].small);
      Split bb[16][2];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const uint2* bp = Bp + (8 * nt + g) * LDB2 + k0 + t;
        if (nt < ntn) {
          bb[nt][0] = {bp[0].x, bp[0].y};
          bb[nt][1] = {bp[4].x, bp[4].y};
        }
      }
      mma3(acc, a, bb, ntn);
    }
    float4* out = reinterpret_cast<float4*>(
        cb + ((size_t)b * nwc + cw) * Q16 * Q16);
    const int KS = Q16 / 8;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
      if (nt < ntn)
        out[(warp * KS + nt) * 32 + lane] =
            make_float4(acc[nt][0], acc[nt][2], acc[nt][1], acc[nt][3]);
    return;
  }

  // cum, dt and w of every head of the group, up front: 128 threads per
  // head, an inclusive scan of dt * A[h] by shuffles within each warp,
  // then the warps' totals added in order
  const int nhd = h_hi - h_lo;
  const int j = tid & 127;
  for (int hb = 0; hb < nhd; hb += kThreads / 128) {
    const int hh = hb + (tid >> 7);
    float d = 0.f;
    if (hh < nhd && j < valid)
      d = to_f32(dt[((size_t)b * S + s0 + j) * nh + h_lo + hh]);
    float v = hh < nhd ? d * A[h_lo + hh] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    for (int w = warp & ~3; w < warp; ++w) v += wsum[w];
    if (hh < nhd && j < Q16) {
      cum[hh * Q16 + j] = v;
      dts[hh * Q16 + j] = d;
    }
    __syncthreads();
  }
  for (int e = tid; e < nhd * Q16; e += kThreads) {
    const int hh = e / Q16;
    const float cj = cum[e], d = dts[e];
    wv[e] = d * expf(cum[hh * Q16 + Q16 - 1] - cj);
    float* o = cv + (((size_t)b * nh + h_lo + hh) * nwc + cw) * 2 * Q16;
    o[e - hh * Q16] = cj;
    o[Q16 + e - hh * Q16] = d;
  }
  if (!states) return;

  for (int h = h_lo; h < h_hi; ++h) {
    const int bi = nbuf == 2 ? (h - h_lo) & 1 : 0;
    if (nbuf == 1) {
      __syncthreads();       // the last head is done with Xs
      load_x(h, 0);
    }
    cp_async_wait_all();
    __syncthreads();         // x of head h landed (and w, at the first)
    if (nbuf == 2 && h + 1 < h_hi) load_x(h + 1, bi ^ 1);
    const float* w_h = wv + (h - h_lo) * Q16;

    // S_c = (x w)^T B, (HD, N), as wgmma: jobs of 64 state rows x 64
    // columns, one warpgroup each; A = (x w)^T split here, each k-step's
    // fragments in registers of their own (none is rewritten while a
    // product reads it), B from B^T's planes
    const float* Xb = Xs + bi * Q16 * LDX;
    float* so = st + (((size_t)b * nh + h) * nwc + cw) * (size_t)HD * N;
    // (a loop whose trip count is the same for both warpgroups: a branch
    // on the warp around a wgmma would serialize the products)
    const int wg = warp >> 2;
    const int KS = Q16 / 8;
    const int njobs = (HD + 63) / 64 * ((N8 + 63) / 64);
    for (int jb = 0; jb < njobs; jb += kWarps / 4) {
      const int job = min(jb + wg, njobs - 1);   // a spare job repeats the
      const bool store = jb + wg < njobs;         // last, unstored
      const int r0 = (job % ((HD + 63) / 64)) * 64 + 16 * (warp & 3);
      const int n0 = (job / ((HD + 63) / 64)) * 64;
      const int pa = r0 + g, pb = pa + 8;
      uint32_t ab[16][4], as[16][4];
      auto frags = [&](int ks) {
        const int j0 = 8 * ks + t, j1 = j0 + 4;
        const float w0 = w_h[j0], w1 = w_h[j1];
        const float v[4] = {pa < HD ? Xb[j0 * LDX + pa] * w0 : 0.f,
                            pb < HD ? Xb[j0 * LDX + pb] * w0 : 0.f,
                            pa < HD ? Xb[j1 * LDX + pa] * w1 : 0.f,
                            pb < HD ? Xb[j1 * LDX + pb] * w1 : 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Split sp = split(v[e]);
          ab[ks][e] = sp.big;
          as[ks][e] = sp.small;
        }
      };
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      const uint32_t bb = smem_u32(Bt) + n0 * 128;
      // two halves of the k-steps: the second half's fragments are
      // computed while the first half's products run
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int ks = 8 * half; ks < 8 * half + 8; ++ks)
          if (ks < KS) frags(ks);
        wgmma_fence();
#pragma unroll
        for (int ks = 8 * half; ks < 8 * half + 8; ++ks) {
          if (ks < KS) {
            const uint32_t o = (ks >> 2) * N8 * 128 + (ks & 3) * 32;
            wgmma_rs(acc, as[ks], gmma_desc(bb + o));
            wgmma_rs(acc, ab[ks], gmma_desc(bb + bts + o));
            wgmma_rs(acc, ab[ks], gmma_desc(bb + o));
          }
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n0 + 8 * n + 2 * t;
        if (store && col < N) {
          if (pa < HD)
            store2(so + (size_t)pa * N + col, acc[n][0], acc[n][1]);
          if (pb < HD)
            store2(so + (size_t)pb * N + col, acc[n][2], acc[n][3]);
        }
      }
    }
  }
}

// ---- (b) the state pass -----------------------------------------------------
// grid (blocks of 4-entry groups x B*nh). Slot cw of st holds S_c for
// chunk c0 + cw (none for the last chunk) and is overwritten with the
// state entering that chunk; `carry` holds the state entering the window
// (first == 0) and receives the state leaving it (more == 1). A thread's
// loads are issued kPassBatch chunks at a time, ahead of its stores: one
// at a time, each waits out a full trip to memory.
constexpr int kPassBatch = 8;
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ st, const float* __restrict__ cv,
                  float* __restrict__ carry, int hdn4, int nblk, int nwc,
                  int nread, int Q16, int first, int more) {
  const int bh = blockIdx.x / nblk;
  const int e = (blockIdx.x - bh * nblk) * kThreads + threadIdx.x;
  if (e >= hdn4) return;
  float4* s = reinterpret_cast<float4*>(st) + (size_t)bh * nwc * hdn4 + e;
  const float* cq = cv + (size_t)bh * nwc * 2 * Q16 + Q16 - 1;
  float4* cr = reinterpret_cast<float4*>(carry) + (size_t)bh * hdn4 + e;
  float4 h = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *cr;
  for (int c0 = 0; c0 < nwc; c0 += kPassBatch) {
    float4 v[kPassBatch];
    float dec[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int cw = c0 + k;
      // past nread (the last chunk has no S_c) the state carries as is
      v[k] = cw < nread ? s[(size_t)cw * hdn4]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      dec[k] = cw < nread ? expf(cq[(size_t)cw * 2 * Q16]) : 1.f;
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      const int cw = c0 + k;
      if (cw < nwc) {
        s[(size_t)cw * hdn4] = h;
        h.x = h.x * dec[k] + v[k].x;
        h.y = h.y * dec[k] + v[k].y;
        h.z = h.z * dec[k] + v[k].z;
        h.w = h.w * dec[k] + v[k].w;
      }
    }
  }
  if (more) *cr = h;
}

// ---- (c) the chunk scan -------------------------------------------------------
// grid (chunks of the window, head groups, B), two warpgroups; warp w owns
// rows 16 w .. 16 w + 15 of the chunk. A unit is PC of one head's columns
// (64, or 32 at hd 32). Per unit, as wgmma with A in registers and B as
// 128B-swizzled TF32 planes in shared memory, three TF32 products each:
//   C h^T: A = C's planes (from (a), read into registers), B = the
//          entering state's planes (split once per unit);
//   G x:   A = G (computed by each warp for its rows from C B^T, cum and
//          dt), B = x's planes, in the same shared memory once C h^T is
//          done;
// then y = G x + exp(cum_i) C h^T. Every k-step's A fragments are in
// registers before the first product, so none is rewritten while a
// product reads it. cp.async stages the next unit's state, then its x,
// as soon as their planes are built.
constexpr int kScanThreads = 256;
template <int HD, typename T>
__global__ void __launch_bounds__(kScanThreads, 1)
chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ cv,
                  const float* __restrict__ cb,
                  const uint32_t* __restrict__ cf,
                  const float* __restrict__ st, T* __restrict__ y, int S,
                  int nh, int N, int Q, int c0, int nwc, int hg, int staged) {
  constexpr int PC = HD < 64 ? HD : 64;          // columns per unit
  constexpr int NPB = HD / PC;                   // units per head
  constexpr int NTW = PC / 8;                    // accumulator column tiles
  const int cw = blockIdx.x;
  const int c = c0 + cw;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const Geo geo = geometry(Q, N, HD);
  const int Q16 = geo.Q16, N8 = geo.N8, NBK = geo.nbk;
  const int s0 = c * Q;
  const int valid = min(Q, S - s0);
  const int h_lo = grp * hg;
  const int nunits = (min(nh, h_lo + hg) - h_lo) * NPB;
  const bool has_state = c > 0;
  const size_t xstep = (size_t)nh * HD;
  const int nrt = Q16 / 16;

  // planes (1024-byte aligned for the swizzle), C B^T's fragments, cum /
  // dt, and the staging
  extern __shared__ float4 smem4[];
  char* Pl = reinterpret_cast<char*>(smem4);
  Pl += (1024 - (smem_u32(Pl) & 1023)) & 1023;
  const int pls = NBK * PC * 128;                // bytes per plane
  float4* cbs = reinterpret_cast<float4*>(Pl + 2 * pls);
  float* vec = reinterpret_cast<float*>(cbs + 32 * nrt * (nrt + 1));
  float* stg_x = vec + 2 * Q16;                  // staged: Q16 x PC
  float* stg_h = stg_x + Q16 * PC;               //         PC x N
  float* stg_v = stg_h + PC * N8;                //         cum, dt

  auto x_src = [&](int u) {
    return x + (((size_t)b * S + s0) * nh + h_lo + u / NPB) * HD
           + (u % NPB) * PC;
  };
  auto h_src = [&](int u) {
    return st + (((size_t)b * nh + h_lo + u / NPB) * nwc + cw) * (size_t)HD * N
           + (size_t)(u % NPB) * PC * N;
  };
  auto v_src = [&](int u) {
    return cv + (((size_t)b * nh + h_lo + u / NPB) * nwc + cw) * 2 * Q16;
  };
  auto stage_h = [&](int u) {
    if (has_state) load_tile(stg_h, N, h_src(u), (size_t)N, PC, PC, N);
    cp_async_commit();
  };
  auto stage_x = [&](int u) {
    load_tile(stg_x, PC, x_src(u), xstep, Q16, valid, PC);
    load_tile(stg_v, 2 * Q16, v_src(u), 0, 1, 1, 2 * Q16);
    cp_async_commit();
  };
  // the state's rows p < PC (columns n < N8, zeros past N) as planes
  // (row p, K = n)
  auto split_h = [&](const float* src) {
    for (int e = tid; e < PC * 32 * ((N8 + 127) / 128); e += kScanThreads) {
      const int p = e >> 5 & (PC - 1), n4 = (e & 31) * 4 + 128 * (e / (PC * 32));
      if (n4 >= N8) continue;
      const float4 v = n4 < N ? load4(src + (size_t)p * N + n4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const Split a = split(v.x), bb = split(v.y), z = split(v.z),
                  w = split(v.w);
      const int off = (n4 >> 5) * PC * 128 + swz128(p, n4 & 31);
      *reinterpret_cast<uint4*>(Pl + off) =
          make_uint4(a.big, bb.big, z.big, w.big);
      *reinterpret_cast<uint4*>(Pl + pls + off) =
          make_uint4(a.small, bb.small, z.small, w.small);
    }
  };
  // x rows j < Q16 (zeros past vrows) as planes transposed (row p, K = j),
  // each group of 8 columns in the order 0 2 4 6 1 3 5 7: G's k index t is
  // column 2t and t + 4 is 2t + 1, as C B^T is stored. A warp writes 32
  // steps j of the same rows, which the swizzle spreads over the banks.
  auto split_x = [&](const auto* src, size_t stride, int vrows) {
    for (int e = tid; e < 128 * (PC / 4); e += kScanThreads) {
      const int j = e & 127, p4 = (e >> 7) * 4;
      if (j >= Q16) continue;
      const float4 v = j < vrows ? load4(src + j * stride + p4)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      const int jj = j & 7;
      const int kp = (j & ~7) + ((jj & 1) ? 4 + (jj >> 1) : (jj >> 1));
      const int blk = (kp >> 5) * PC * 128;
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Split sp = split(vals[i]);
        const int off = blk + swz128(p4 + i, kp & 31);
        *reinterpret_cast<uint32_t*>(Pl + off) = sp.big;
        *reinterpret_cast<uint32_t*>(Pl + pls + off) = sp.small;
      }
    }
  };

  // C B^T's fragments, warp w's k-steps 0 .. 2w + 1 from offset w (w + 1)
  // 32, once for the group
  {
    const float* src = cb + ((size_t)b * nwc + cw) * Q16 * Q16;
    for (int w = 0; w < nrt; ++w)
      for (int e = tid; e < (2 * w + 2) * 32; e += kScanThreads)
        cp_async16(cbs + w * (w + 1) * 32 + e,
                   src + ((size_t)w * (Q16 / 8) * 32 + e) * 4, 16);
  }
  if (staged) {
    stage_h(0);
    stage_x(0);
  } else {
    cp_async_commit();
  }

  // every branch around a wgmma is uniform over the CTA (a branch on the
  // warp would serialize the products): both warpgroups run every k-step,
  // rows past the chunk and columns past a row's diagonal are zeros
  const bool rows_on = warp < nrt;
  const int i0 = 16 * warp + g, i1 = i0 + 8;
  const int ksg = Q16 / 8;                       // G x k-steps
  const int KSC = N8 / 8;                        // C h^T k-steps
  const uint4* cfp = reinterpret_cast<const uint4*>(
                         cf + ((size_t)b * nwc + cw) * Q16 * N8 * 2)
                     + (size_t)(rows_on ? warp : 0) * KSC * 64 + 2 * lane;
  const uint32_t pa = smem_u32(Pl);

  uint32_t ab[16][4], as[16][4];
  // this warp's rows of C's planes, k-steps kb .. kb + 15
  auto load_c = [&](int kb) {
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      if (kb + ks < KSC) {
        const uint4 vb = rows_on ? __ldg(cfp + (kb + ks) * 64)
                                 : make_uint4(0u, 0u, 0u, 0u);
        const uint4 vs = rows_on ? __ldg(cfp + (kb + ks) * 64 + 1)
                                 : make_uint4(0u, 0u, 0u, 0u);
        ab[ks][0] = vb.x;
        ab[ks][1] = vb.y;
        ab[ks][2] = vb.z;
        ab[ks][3] = vb.w;
        as[ks][0] = vs.x;
        as[ks][1] = vs.y;
        as[ks][2] = vs.z;
        as[ks][3] = vs.w;
      }
    }
  };

  for (int u = 0; u < nunits; ++u) {
    if (has_state) load_c(0);     // in flight during the split
    cp_async_wait_all();
    __syncthreads();         // unit u - 1 is done with the planes
    if (tid < 2 * Q16) vec[tid] = staged ? stg_v[tid] : v_src(u)[tid];
    if (has_state) split_h(staged ? stg_h : h_src(u));
    fence_proxy_async();     // the planes, written by threads, read by wgmma
    __syncthreads();
    if (staged && u + 1 < nunits) stage_h(u + 1);

    float accC[NTW][4], accG[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) accC[n][e] = accG[n][e] = 0.f;
    if (has_state) {
      for (int kb = 0; kb < KSC; kb += 16) {
        if (kb > 0) load_c(kb);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 16; ++ks) {
          if (kb + ks < KSC) {
            const uint32_t o =
                ((kb + ks) >> 2) * PC * 128 + ((kb + ks) & 3) * 32;
            wgmma_rs(accC, as[ks], gmma_desc(pa + o));
            wgmma_rs(accC, ab[ks], gmma_desc(pa + pls + o));
            wgmma_rs(accC, ab[ks], gmma_desc(pa + o));
          }
        }
        wgmma_commit();
        wgmma_wait0();
      }
      fence_regs(accC);
    }
    __syncthreads();         // C h^T is done with the state's planes
    if (staged)
      split_x(stg_x, (size_t)PC, Q16);
    else
      split_x(x_src(u), xstep, valid);
    fence_proxy_async();
    __syncthreads();
    if (staged && u + 1 < nunits) stage_x(u + 1);

    // G's fragments for every k-step, then G x
    const float* cum = vec;
    const float* dts = vec + Q16;
    const float ci0 = rows_on ? cum[i0] : 0.f;
    const float ci1 = rows_on ? cum[i1] : 0.f;
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      if (ks < ksg) {
        float gv[4] = {0.f, 0.f, 0.f, 0.f};
        if (rows_on && ks < 2 * warp + 2) {
          const int j0 = 8 * ks + 2 * t, j1 = j0 + 1;
          const float4 q = cbs[warp * (warp + 1) * 32 + ks * 32 + lane];
          const float cj0 = cum[j0], cj1 = cum[j1];
          const float d0 = dts[j0], d1 = dts[j1];
          gv[0] = j0 <= i0 ? q.x * expf(fminf(ci0 - cj0, 0.f)) * d0 : 0.f;
          gv[1] = j0 <= i1 ? q.y * expf(fminf(ci1 - cj0, 0.f)) * d0 : 0.f;
          gv[2] = j1 <= i0 ? q.z * expf(fminf(ci0 - cj1, 0.f)) * d1 : 0.f;
          gv[3] = j1 <= i1 ? q.w * expf(fminf(ci1 - cj1, 0.f)) * d1 : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Split sp = split(gv[e]);
          ab[ks][e] = sp.big;
          as[ks][e] = sp.small;
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      if (ks < ksg) {
        const uint32_t o = (ks >> 2) * PC * 128 + (ks & 3) * 32;
        wgmma_rs(accG, as[ks], gmma_desc(pa + o));
        wgmma_rs(accG, ab[ks], gmma_desc(pa + pls + o));
        wgmma_rs(accG, ab[ks], gmma_desc(pa + o));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(accG);
    const float e0 = expf(ci0), e1 = expf(ci1);
    const int h = h_lo + u / NPB;
    const int p0 = (u % NPB) * PC;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int p = p0 + 8 * n + 2 * t;
      if (i0 < valid)
        store2(y + (((size_t)b * S + s0 + i0) * nh + h) * HD + p,
               accG[n][0] + e0 * accC[n][0], accG[n][1] + e0 * accC[n][1]);
      if (i1 < valid)
        store2(y + (((size_t)b * S + s0 + i1) * nh + h) * HD + p,
               accG[n][2] + e1 * accC[n][2], accG[n][3] + e1 * accC[n][3]);
    }
  }
  cp_async_wait_all();
}

// ---- host side ----------------------------------------------------------------
// chunks per window and the workspace (floats) for it
struct Plan {
  int nc, nw;
  long long cv, cb, cf, st, carry;   // offsets, floats
  long long total;
};
Plan plan(int Bsz, int S, int nh, int hd, int N, int Q) {
  const Geo geo = geometry(Q, N, hd);
  Plan p;
  p.nc = (S + Q - 1) / Q;
  const long long per_chunk =
      (long long)Bsz * nh * (2 * geo.Q16 + (long long)hd * N)
      + (long long)Bsz * geo.Q16 * (geo.Q16 + 2ll * geo.N8);
  long long nw = kWorkspaceCap / (per_chunk > 0 ? per_chunk : 1);
  if (nw < 1) nw = 1;
  p.nw = (int)(nw < p.nc ? nw : p.nc);
  p.cv = 0;
  p.cb = p.cv + (long long)Bsz * nh * p.nw * 2 * geo.Q16;
  p.cf = p.cb + (long long)Bsz * p.nw * geo.Q16 * geo.Q16;
  p.st = p.cf + (long long)Bsz * p.nw * geo.Q16 * geo.N8 * 2;
  p.carry = p.st + (long long)Bsz * nh * p.nw * hd * N;
  p.total = p.carry + (p.nw < p.nc ? (long long)Bsz * nh * hd * N : 0);
  return p;
}

// shared memory and buffering of (a) and (c): (a) double-buffers x where
// it fits, (c) stages float32 inputs where it fits
struct Smem {
  int nbuf_a, smem_a, staged_c, smem_c;
};
Smem smem_plan(int Q, int N, int hd, bool is_f32) {
  const Geo geo = geometry(Q, N, hd);
  Smem m;
  m.nbuf_a = state_smem_bytes(geo, 2) <= kSmemBlock ? 2 : 1;
  m.smem_a = (int)state_smem_bytes(geo, m.nbuf_a);
  m.staged_c = is_f32 && scan_smem_bytes(geo, 1) <= kSmemBlock;
  m.smem_c = (int)scan_smem_bytes(geo, m.staged_c);
  return m;
}

int sm_count(int dev) {
  static std::atomic<int> sms[kMaxDevices];
  if (dev < kMaxDevices && sms[dev].load() > 0) return sms[dev].load();
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
      != cudaSuccess || n <= 0)
    n = 132;
  if (dev < kMaxDevices) sms[dev].store(n);
  return n;
}

// heads per CTA of (a) and (c), one CTA per SM: the fewest waves of
// (group + 1) heads' work, the "+ 1" for a CTA's own loads; ties go to
// the larger group
int pick_group(int nh, long long units, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int hgp = 1; hgp <= kMaxGroup && hgp <= nh; ++hgp) {
    const long long ctas = (long long)((nh + hgp - 1) / hgp) * units;
    const long long cost = ((ctas + sms - 1) / sms) * (hgp + 1);
    if (best_cost < 0 || cost <= best_cost) {
      best = hgp;
      best_cost = cost;
    }
  }
  return best;
}

// the dynamic shared-memory limit is raised once per instantiation and
// card, to the largest size asked for so far
template <typename K>
cudaError_t allow_smem(K kern, std::atomic<int> (&allowed)[kMaxDevices],
                       int dev, int smem) {
  if (dev < kMaxDevices && smem <= allowed[dev].load()) return cudaSuccess;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (dev < kMaxDevices) allowed[dev].store(smem);
  return cudaSuccess;
}

template <int HD, typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, float* ws,
                   int Bsz, int S, int nh, int N, int Q, int dev,
                   cudaStream_t s) {
  static std::atomic<int> allowed_a[kMaxDevices], allowed_c[kMaxDevices];
  const Geo geo = geometry(Q, N, HD);
  const Plan p = plan(Bsz, S, nh, HD, N, Q);
  const Smem m = smem_plan(Q, N, HD, sizeof(T) == 4);
  auto ka = chunk_state_kernel<HD, T>;
  auto kc = chunk_scan_kernel<HD, T>;
  cudaError_t err = allow_smem(ka, allowed_a, dev, m.smem_a);
  if (err != cudaSuccess) return err;
  err = allow_smem(kc, allowed_c, dev, m.smem_c);
  if (err != cudaSuccess) return err;

  const int sms = sm_count(dev);
  float* cv = ws + p.cv;
  float* cb = ws + p.cb;
  uint32_t* cf = reinterpret_cast<uint32_t*>(ws + p.cf);
  float* st = ws + p.st;
  float* carry = ws + p.carry;
  const int hdn4 = HD * N / 4;
  const int nblk = (hdn4 + kThreads - 1) / kThreads;
  for (int c0 = 0; c0 < p.nc; c0 += p.nw) {
    const int nwc = p.nw < p.nc - c0 ? p.nw : p.nc - c0;
    const int hg = pick_group(nh, (long long)nwc * Bsz, sms);
    const int ng = (nh + hg - 1) / hg;
    ka<<<dim3(nwc, ng + 1, Bsz), kThreads, m.smem_a, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), cv, cb, cf, st, S, nh, N, Q, p.nc, c0,
        nwc, hg, m.nbuf_a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (p.nc > 1) {
      const int nread = (p.nc - 1 - c0) < nwc ? (p.nc - 1 - c0) : nwc;
      state_pass_kernel<<<dim3((unsigned)((long long)nblk * Bsz * nh)),
                          kThreads, 0, s>>>(
          st, cv, carry, hdn4, nblk, nwc, nread, geo.Q16, c0 == 0 ? 1 : 0,
          c0 + nwc < p.nc ? 1 : 0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    kc<<<dim3(nwc, ng, Bsz), kScanThreads, m.smem_c, s>>>(
        static_cast<const T*>(x), cv, cb, cf, st, static_cast<T*>(y), S, nh,
        N, Q, c0, nwc, hg, m.staged_c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, float* ws,
                     int Bsz, int S, int nh, int hd, int N, int Q, int dev,
                     cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<32, T>(x, dt, A, Bm, Cm, y, ws, Bsz, S, nh, N, Q, dev, s);
    case 64:
      return launch<64, T>(x, dt, A, Bm, Cm, y, ws, Bsz, S, nh, N, Q, dev, s);
    case 128:
      return launch<128, T>(x, dt, A, Bm, Cm, y, ws, Bsz, S, nh, N, Q, dev,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of card `device`; returns a cudaError_t (0 on
// success). The wrapper has checked hd in {32, 64, 128}, N % 4 == 0,
// 1 <= Q <= 128, the shared memory, contiguity, alignment and the type
// (is_bf16: 0 float32, 1 bfloat16; A is float32), and passes `ws`, a
// float32 workspace of ssd_scan_workspace_floats(...) entries.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* ws,
                    int Bsz, int S, int nh, int hd, int N, int Q, int is_bf16,
                    int device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  err = is_bf16 ? dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, w, Bsz, S, nh,
                                          hd, N, Q, device, s)
                : dispatch<float>(x, dt, A, Bm, Cm, y, w, Bsz, S, nh, hd, N,
                                  Q, device, s);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// float32 entries of the workspace one call needs
long long ssd_scan_workspace_floats(int Bsz, int S, int nh, int hd, int N,
                                    int Q) {
  return plan(Bsz, S, nh, hd, N, Q).total;
}

// CTAs of the three kernels (chunk states with C B^T, state pass, chunk
// scan) in the first window of a call at these shapes on card `device`,
// into ctas[0..2]; returns the number of windows.
int ssd_scan_ctas(int Bsz, int S, int nh, int hd, int N, int Q, int device,
                  long long* ctas) {
  const Plan p = plan(Bsz, S, nh, hd, N, Q);
  const int hg = pick_group(nh, (long long)p.nw * Bsz, sm_count(device));
  const long long ng = (nh + hg - 1) / hg;
  const long long nblk = (hd * N / 4 + kThreads - 1) / kThreads;
  ctas[0] = (long long)p.nw * (ng + 1) * Bsz;
  ctas[1] = p.nc > 1 ? nblk * Bsz * nh : 0;
  ctas[2] = (long long)p.nw * ng * Bsz;
  return (p.nc + p.nw - 1) / p.nw;
}

// Dynamic shared memory the largest of the kernels needs for chunk Q,
// state N and head dim hd (x single-buffered, the scan unstaged: their
// least).
long long ssd_scan_smem_bytes(int Q, int N, int hd) {
  const Geo geo = geometry(Q, N, hd);
  const long long a = state_smem_bytes(geo, 1);
  const long long c = scan_smem_bytes(geo, 0);
  return a > c ? a : c;
}

}  // extern "C"
