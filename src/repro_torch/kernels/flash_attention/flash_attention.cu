// Blockwise online-softmax attention for NVIDIA Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py, launched by
// `flash_attention_pallas` through `ops.py::flash_attention`): causal and
// sliding-window attention with GQA, query head h reading kv head
// h / (H / K).
//
//   q    (B, H, S, D)   float32 or bfloat16, contiguous
//   k, v (B, K, T, D)   the same type
//   out  (B, H, S, D)   q's type; accumulation is float32
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
// What bounds it on the card: operations, 4 D flops per valid (query,
// key) pair against 2 D values of K/V read per key and query tile, far
// above the card's bytes:flops balance. So both products run on the
// tensor cores, on one of two routes:
//
// bf16 at D = 64 and 128 (wgmma, warp-specialized; FlashAttention-3's
// layout without its intra-warpgroup overlap):
//   - one CTA of two consumer warpgroups (64 query rows each, 128 per
//     CTA) and one producer warp per (query tile, head, batch row);
//   - the producer's lane 0 loads Q once and K/V tiles of 128 keys into
//     a ring of 3-4 shared-memory stages with TMA (128-byte swizzle, rows
//     past T zero-filled by the hardware), each stage guarded by a "full"
//     and an "empty" mbarrier; the consumers never barrier with each
//     other, so one warpgroup's softmax overlaps the other's products;
//   - S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//     (K-major); P is rounded to bf16 in registers and fed straight back
//     as wgmma's register A operand for O += P V, V read MN-major (the
//     hardware transposes it); l sums the rounded P, so a row's weights
//     sum to one exactly; f32 accumulation throughout.
// Everything else (f32; bf16 at D = 32 and 256) runs FA-2's layout with
// mma.sync:
//   - one CTA of 4 warps per (64-query tile, head, batch row), each warp
//     owning 16 query rows; Q, K and V in the input type in shared memory,
//     rows padded by 16 bytes (no bank conflicts for ldmatrix or the f32
//     fragment loads); K/V tiles through a 2-stage ring of cp.async
//     16-byte copies, one __syncthreads per tile;
//   - bf16: mma.m16n8k16, fragments by ldmatrix (.trans for V);
//   - f32: 3xTF32, as PyTorch's own f32 attention does: each operand x
//     is split into big = tf32(x) and small = tf32(x - big) (round to
//     nearest) and acc += a_small b_big + a_big b_small + a_big b_big
//     through mma.m16n8k8.tf32, for both products; P stays in registers
//     (its key order within 8 keys is permuted to the accumulator's, and
//     V's rows are read in the same order). The splits are ALU work, and
//     they, not the tensor cores, bound this route: key tiles are 32 keys
//     (more CTAs per SM), and at D <= 64 each K/V tile is split once into
//     TF32 big/small planes in shared memory instead of by every warp.
// Both routes: tiles are launched in reverse so the causal tiles with the
// most keys start first; the loop over key tiles covers only the tiles
// the masks leave some key in (causal stops at the tile's last query, a
// window starts at its first query - window + 1; skipping a fully masked
// tile is exact); ragged S and T are handled in place, no padding copies;
// the online softmax runs on the accumulator fragments (a row's max and
// sum are quad shuffles) and masks are computed only on key tiles that
// hold a masked key. Left on the table: wgmma for f32 (3xTF32 from split
// copies of K and V in shared memory); FA-3's intra-warpgroup overlap of
// the softmax with the P V product (it holds P and S at once: at the
// 224-register cap of a 288-thread CTA that spills, so it needs a
// producer warpgroup that gives its registers up with setmaxnreg).
// Ping-pong scheduling of the two warpgroups (a turn handed over through
// mbarriers once a product is done) was slower: the warpgroups already
// drift apart on their own, and the hand-over leaves one of them idle.

#include <cuda.h>   // CUtensorMap (the encoder is fetched through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;       // query rows per CTA
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int D>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  // keys per tile: 32 for f32 (more CTAs per SM for the splits' ALU
  // work) and D = 256, else 64
  static constexpr int BK = D > 128 || !kBf16 ? 32 : 64;
  static constexpr int LD = D + 16 / (int)sizeof(T);  // smem row, elements
  static constexpr int NT = BK / 8;               // score n-tiles
  static constexpr int NO = D / 8;                // output n-tiles
  // Q fragments kept in registers for the whole key loop; Q then only
  // passes through the second K/V stage before the loop
  static constexpr bool kQReg = kBf16 ? D <= 128 : D <= 64;
  static constexpr int KQ = kBf16 ? D / 16 : D / 8;  // k-steps of Q K^T
  // f32 at D <= 64: each K/V tile is split into TF32 (big, small) planes
  // once per CTA rather than by every warp (above, the planes would cost
  // a CTA per SM)
  static constexpr bool kPreSplit = !kBf16 && D <= 64;
  static constexpr size_t kSmem =        // [Q +] 2 x (K, V) [+ 4 planes]
      sizeof(T) * (size_t)LD
      * ((kQReg ? 0 : kBQ) + 4 * BK + (kPreSplit ? 4 * BK : 0));
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, nrows) of a (rows, D) matrix into shared memory with row
// stride LD; rows >= valid are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int nrows,
                                          int valid) {
  constexpr int PPR = D * (int)sizeof(T) / 16;   // 16-byte pieces per row
  constexpr int EPP = 16 / (int)sizeof(T);       // elements per piece
  for (int e = threadIdx.x; e < nrows * PPR; e += kThreads) {
    const int r = e / PPR;
    const int c = (e - r * PPR) * EPP;
    const bool ok = r < valid;
    cp_async16(dst + r * Cfg<T, D>::LD + c,
               ok ? src + (size_t)r * D + c : src, ok ? 16 : 0);
  }
}

// ---- bf16 tensor-core pieces ----------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- wgmma pieces (bf16, sm_90a) ------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// accumulators are written asynchronously: pin them after the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
// shared memory written by the threads (cp.async) made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Matrix descriptor of a 128-byte-swizzled operand in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 64) {=, +=} A (64 x 16) B (64 x 16), both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128) {=, +=} A (64 x 16) B (128 x 16), both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) {=, +=} A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 128) {=, +=} A (64 x 16, registers) B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


// ---- 3xTF32 pieces --------------------------------------------------------
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
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// rows [0, nrows) of a float32 tile (row stride D + 4) as TF32 big and
// small planes with the same layout
template <int D>
__device__ __forceinline__ void split_rows(uint32_t* big, uint32_t* small,
                                           const float* src, int nrows) {
  constexpr int LD = D + 4, V4 = D / 4;
  for (int e = threadIdx.x; e < nrows * V4; e += kThreads) {
    const int r = e / V4;
    const int c = (e - r * V4) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * LD + c);
    const Split a = split(x.x), b = split(x.y), z = split(x.z),
                w = split(x.w);
    *reinterpret_cast<uint4*>(big + r * LD + c) =
        make_uint4(a.big, b.big, z.big, w.big);
    *reinterpret_cast<uint4*>(small + r * LD + c) =
        make_uint4(a.small, b.small, z.small, w.small);
  }
}

// acc += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Split (&a)[4],
                                           const Split (&b)[2]) {
  mma_tf32(c, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big,
           b[1].big);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small,
           b[1].small);
  mma_tf32(c, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Fragment conventions (m16n8 accumulator, PTX ISA; the wgmma m64nN
// accumulator is the same per warp): lane = 4 g + t holds rows g and g + 8,
// columns 2t and 2t + 1 of each 8-column n-tile:
// c[0] (g, 2t), c[1] (g, 2t+1), c[2] (g+8, 2t), c[3] (g+8, 2t+1).

// Mask the scores of a warp's 16 rows (r0 ..) against keys k0 .. k0 +
// 8 NT - 1, only where the tile holds a masked key for these rows.
template <int NT>
__device__ __forceinline__ void apply_mask(float (&s)[NT][4], int r0, int k0,
                                           int g, int t4, int T_, int causal,
                                           int window) {
  const bool need_mask = k0 + 8 * NT > T_ || (causal && k0 + 8 * NT - 1 > r0)
                         || (window && k0 <= r0 + 15 - window);
  if (!need_mask) return;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = r0 + g + 8 * (e >> 1);
      const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
      const bool ok = kp < T_ && (!causal || kp <= qp)
                      && (!window || kp > qp - window);
      if (!ok) s[j][e] = kNegInf;
    }
}

// Online softmax on the fragments, rows g (hh 0) and g+8 (hh 1): s becomes
// P, m and l move on, and alpha is what the row's O must be scaled by.
// bf16 takes exponentials base 2 (the scale carries log2 e) and rounds P
// to bf16, which is what P V sees, and l sums the rounded P. l is this
// lane's columns only (quad-summed at the end). O is not touched, so a
// P V product into O may still be in flight.
template <bool kBf16, int NT>
__device__ __forceinline__ void softmax_p(float (&s)[NT][4], float (&m)[2],
                                          float (&l)[2], float (&alpha)[2],
                                          float scale) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float mn = fmaxf(m[hh], mx);
    // a row with no valid key so far keeps p = 0: exp of -1e30 * scale
    const float mref = mn <= kNegInf * 0.5f ? 0.f : mn * scale;
    alpha[hh] = m[hh] <= kNegInf * 0.5f ? 0.f
                : kBf16 ? exp2f((m[hh] - mn) * scale)
                        : expf((m[hh] - mn) * scale);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
        float p;
        if constexpr (kBf16) {
          p = exp2f(fmaf(s[j][e], scale, -mref));
          p = __bfloat162float(__float2bfloat16(p));
        } else {
          p = expf(fmaf(s[j][e], scale, -mref));
        }
        s[j][e] = p;
        rs += p;
      }
    l[hh] = alpha[hh] * l[hh] + rs;
    m[hh] = mn;
  }
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4],
                                        float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// out rows r0 + g (+ 8) = O / max(l, 1e-30), l quad-summed first
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, size_t row0,
                                           float (&o)[D / 8][4],
                                           float (&l)[2], int r0,
                                           int g, int t4, int S) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int qp = r0 + g + 8 * hh;
    if (qp >= S) continue;
    T* orow = out + (row0 + qp) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + n * 8, o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int S, int T_, int causal, int window,
                       float scale) {
  using C = Cfg<T, D>;
  constexpr int BK = C::BK, LD = C::LD, NT = C::NT, NO = C::NO, KQ = C::KQ;
  constexpr bool kBf16 = C::kBf16;
  static_assert(kBQ <= 2 * BK, "Q must fit in one K/V stage");
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s: K at KV + 2 s BK LD, V after it
  T* KV = reinterpret_cast<T*>(smem) + (C::kQReg ? 0 : kBQ * LD);
  T* Qs = C::kQReg ? KV + 2 * BK * LD : reinterpret_cast<T*>(smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const T* qb = q + ((size_t)(b * H + h) * S + q0) * D;
  const T* kb = k + (size_t)(b * K + kh) * T_ * D;
  const T* vb = v + (size_t)(b * K + kh) * T_ * D;

  // key tiles that hold a key some query row of this tile may see
  const int q_last = min(S, q0 + kBQ) - 1;
  const int hi = causal ? min(T_, q_last + 1) : T_;
  int lo = window ? max(0, q0 - window + 1) : 0;
  lo = (lo / BK) * BK;
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  auto load_kv = [&](int it) {
    const int k0 = lo + it * BK;
    T* Ks = KV + (it & 1) * 2 * BK * LD;
    load_rows<T, D>(Ks, kb + (size_t)k0 * D, BK, T_ - k0);
    load_rows<T, D>(Ks + BK * LD, vb + (size_t)k0 * D, BK, T_ - k0);
  };
  load_rows<T, D>(Qs, qb, kBQ, S - q0);
  cp_async_commit();
  if (ntiles > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();                       // Q landed
  // (with kQReg, tile 1 overwrites Q only after the loop's first barrier,
  // which every warp reaches with its Q fragments in registers)

  const T* Qw = Qs + warp * 16 * LD;     // this warp's 16 query rows
  // Q fragments: bf16 A operands (4 regs per k16) or f32 3xTF32 splits
  uint32_t qa[C::kQReg && kBf16 ? KQ : 1][4];
  Split qs[C::kQReg && !kBf16 ? KQ : 1][4];
  auto q_frag_bf16 = [&](int kc, uint32_t (&a)[4]) {
    ldmatrix_x4(a, Qw + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
  };
  auto q_frag_f32 = [&](int kc, Split (&a)[4]) {
    const float* p = reinterpret_cast<const float*>(Qw) + kc * 8 + t4;
    a[0] = split(p[g * LD]);
    a[1] = split(p[(g + 8) * LD]);
    a[2] = split(p[g * LD + 4]);
    a[3] = split(p[(g + 8) * LD + 4]);
  };
  if constexpr (C::kQReg) {
#pragma unroll
    for (int kc = 0; kc < KQ; ++kc) {
      if constexpr (kBf16)
        q_frag_bf16(kc, qa[kc]);
      else
        q_frag_f32(kc, qs[kc]);
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16;          // this warp's first query row

  // the TF32 planes of the current tile: K big, K small, V big, V small
  uint32_t* const Pl = reinterpret_cast<uint32_t*>(KV + 4 * BK * LD);
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();     // tile it landed for all; tile it-1 is done with
    const T* Ks = KV + (it & 1) * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;
    if constexpr (C::kPreSplit) {
      split_rows<D>(Pl, Pl + BK * LD, reinterpret_cast<const float*>(Ks), BK);
      split_rows<D>(Pl + 2 * BK * LD, Pl + 3 * BK * LD,
                    reinterpret_cast<const float*>(Vs), BK);
    }
    if (it + 1 < ntiles) load_kv(it + 1);
    cp_async_commit();
    if constexpr (C::kPreSplit) __syncthreads();   // the planes are written
    const int k0 = lo + it * BK;

    // ---- S = Q K^T (16 x BK per warp) ----
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int kc = 0; kc < KQ; ++kc) {
        uint32_t a[4];
        if constexpr (C::kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kc][e];
        } else {
          q_frag_bf16(kc, a);
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t bb[4];
          ldmatrix_x4(bb, Ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                              + kc * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * jp], a, bb[0], bb[1]);
          mma_bf16(s[2 * jp + 1], a, bb[2], bb[3]);
        }
      }
    } else {
      const float* Kf = reinterpret_cast<const float*>(Ks);
#pragma unroll
      for (int kc = 0; kc < KQ; ++kc) {
        Split a[4];
        if constexpr (C::kQReg) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qs[kc][e];
        } else {
          q_frag_f32(kc, a);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int i = (j * 8 + g) * LD + kc * 8 + t4;
          if constexpr (C::kPreSplit) {
            const uint32_t* kb = Pl + i;
            const uint32_t* ks = Pl + BK * LD + i;
            const Split bb[2] = {{kb[0], ks[0]}, {kb[4], ks[4]}};
            mma_3xtf32(s[j], a, bb);
          } else {
            const Split bb[2] = {split(Kf[i]), split(Kf[i + 4])};
            mma_3xtf32(s[j], a, bb);
          }
        }
      }
    }

    apply_mask(s, r0, k0, g, t4, T_, causal, window);
    float alpha[2];
    softmax_p<kBf16>(s, m, l, alpha, scale);
    rescale(o, alpha);

    // ---- O += P V ----
    if constexpr (kBf16) {
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, Vs + (kc * 16 + (lane & 15)) * LD + np * 16
                                    + (lane >> 4) * 8);
          mma_bf16(o[2 * np], a, bb[0], bb[1]);
          mma_bf16(o[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    } else {
      const float* Vf = reinterpret_cast<const float*>(Vs);
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) {
        // A's k index t holds key 2t, k index t + 4 key 2t + 1 (the
        // accumulator's own columns); V's rows are read in that order
        const Split a[4] = {split(s[kc][0]), split(s[kc][2]),
                            split(s[kc][1]), split(s[kc][3])};
        const int i = (kc * 8 + 2 * t4) * LD + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          if constexpr (C::kPreSplit) {
            const uint32_t* vb = Pl + 2 * BK * LD + i + n * 8;
            const uint32_t* vs = Pl + 3 * BK * LD + i + n * 8;
            const Split bb[2] = {{vb[0], vs[0]}, {vb[LD], vs[LD]}};
            mma_3xtf32(o[n], a, bb);
          } else {
            const Split bb[2] = {split(Vf[i + n * 8]),
                                 split(Vf[i + LD + n * 8])};
            mma_3xtf32(o[n], a, bb);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  store_rows<T, D>(out, (size_t)(b * H + h) * S, o, l, r0, g, t4, S);
}

// ---- bf16 on wgmma, warp-specialized with TMA (D = 64, 128) ---------------
// Two consumer warpgroups (64 query rows each) and one producer warp. The
// producer's lane 0 loads Q once and then K/V tiles into a ring of
// shared-memory stages with TMA (cp.async.bulk.tensor, 128-byte swizzle,
// rows past T zero-filled by the hardware); each stage has a "full"
// mbarrier (the TMA bytes landed) and an "empty" one (both warpgroups are
// done with it). The consumers never wait for each other: a warpgroup
// waits for its stage, runs Q K^T, the online softmax and P V, and frees
// the stage, so one warpgroup's softmax overlaps the other's products.
constexpr int kTmaThreads = 288;           // 2 warpgroups + 1 producer warp
constexpr int kTmaBQ = 128;                // query rows per CTA
constexpr int kTmaBK = 128;                // keys per tile

template <int D>
struct TmaCfg {
  static constexpr int kQBytes = kTmaBQ * D * 2;
  static constexpr int kTileBytes = kTmaBK * D * 2;    // one K or V tile
  // as many stages as fit beside Q in 227 KB, at most 4
  static constexpr int kStages =
      (232448 - 1024 - 256 - kQBytes) / (2 * kTileBytes) > 4
          ? 4 : (232448 - 1024 - 256 - kQBytes) / (2 * kTileBytes);
  static constexpr size_t kSmem =
      kQBytes + 2 * (size_t)kStages * kTileBytes + 1024 + 256;
  static_assert(kStages >= 2, "two K/V stages must fit");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete. A pipeline fault
// would otherwise spin forever: past 2^22 polls (tens of milliseconds at
// the least, where a real wait takes microseconds) the kernel traps, and
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (n > (1u << 22)) __trap();
  }
}
// box (64 columns, rows, 1) of a 3-D tensor map at (c0, c1, c2) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// O (64 x D per warpgroup) += P (registers) V (the stage's V tile at
// v_addr, MN-major): BK/16 products of 16 keys, one commit group
template <int NO, int KC>
__device__ __forceinline__ void pv_products(float (&o)[NO][4],
                                            uint32_t (&pa)[KC][4],
                                            uint32_t v_addr) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    wgmma_rs(o, pa[kc],
             gmma_desc(v_addr + kc * 16 * 128, KC * 16 * 128, 1024), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
flash_attention_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           __nv_bfloat16* __restrict__ out, int H, int K,
                           int S, int T_, int causal, int window,
                           float scale) {
  using T = __nv_bfloat16;
  using C = TmaCfg<D>;
  constexpr int BK = kTmaBK, NT = BK / 8, NO = D / 8, ST = C::kStages;
  constexpr int NP = D / 64;                 // 64-column panels per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* KV = Qs + C::kQBytes;       // stage s: K, then V
  const uint32_t bars = smem_u32(KV + 2 * (size_t)ST * C::kTileBytes);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (ST + st); };
  const uint32_t q_full = bars + 8 * 2 * ST;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTmaBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q_last = min(S, q0 + kTmaBQ) - 1;
  const int hi = causal ? min(T_, q_last + 1) : T_;
  int lo = window ? max(0, q0 - window + 1) : 0;
  lo = (lo / BK) * BK;
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 256);    // every consumer thread
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                  // ---- producer warp ----
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < NP; ++p)
        tma_load_3d(smem_u32(Qs) + p * kTmaBQ * 128, &qmap, q_full, 64 * p,
                    q0, b * H + h);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % ST;
        if (it >= ST) mbar_wait(empty(st), ((it / ST) - 1) & 1);
        const uint32_t ks = smem_u32(KV) + st * 2 * C::kTileBytes;
        const int k0 = lo + it * BK;
        mbar_expect_tx(full(st), 2 * C::kTileBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(ks + p * BK * 128, &kmap, full(st), 64 * p, k0,
                      b * K + kh);
          tma_load_3d(ks + C::kTileBytes + p * BK * 128, &vmap, full(st),
                      64 * p, k0, b * K + kh);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int w0 = q0 + 64 * wg;
  const int hi_w = w0 >= S ? 0 : causal ? min(T_, min(S, w0 + 64)) : T_;
  const int lo_w = window ? max(0, w0 - window + 1) : 0;
  const int r0 = w0 + 16 * warp;
  const uint32_t q_addr = smem_u32(Qs) + wg * 64 * 128;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);       // (also when there is no tile: no TMA may
                              // still be in flight when the CTA exits)

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % ST;
    const int k0 = lo + it * BK;
    mbar_wait(full(st), (it / ST) & 1);
    if (k0 < hi_w && k0 + BK > lo_w) {       // some key for these rows
      // S = Q K^T: 64 x BK for this warpgroup, D/16 k-steps
      const uint32_t k_addr = smem_u32(KV) + st * 2 * C::kTileBytes;
      const uint32_t v_addr = k_addr + C::kTileBytes;
      float s[NT][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        wgmma_ss(s,
                 gmma_desc(q_addr + (ks >> 2) * kTmaBQ * 128 + off, 16, 1024),
                 gmma_desc(k_addr + (ks >> 2) * BK * 128 + off, 16, 1024),
                 ks > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      apply_mask(s, r0, k0, g, t4, T_, causal, window);
      float alpha[2];
      softmax_p<true>(s, m, l, alpha, scale);
      rescale(o, alpha);
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        pa[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        pa[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        pa[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      }
      wgmma_fence();
      pv_products(o, pa, v_addr);
      wgmma_wait0();
      fence_regs(o);
    }
    mbar_arrive(empty(st));    // this thread is done with the stage
  }
  store_rows<T, D>(out, (size_t)(b * H + h) * S, o, l, r0, g, t4, S);
}

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point
// lookup (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// (rows, D) bf16 slices, `slices` of them, read in boxes of 64 columns x
// `box_rows` rows with the 128-byte swizzle; rows past `rows` read as 0
bool make_map(CUtensorMap* map, const void* base, int D, int rows,
              int slices, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)D * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int K, int S, int T_, int causal,
                   int window, float scale, cudaStream_t s) {
  // bf16 takes its exponentials base 2: fold log2(e) into the scale
  const float sc = Cfg<T, D>::kBf16 ? scale * kLog2e : scale;
  if constexpr (Cfg<T, D>::kBf16 && (D == 64 || D == 128)) {
    // with no key (T = 0) the K/V maps are never read: they get one row
    // of q's memory, since a tensor map needs a nonzero extent
    const void* kb = T_ > 0 ? k : q;
    const void* vb = T_ > 0 ? v : q;
    CUtensorMap qm, km, vm;
    if (!make_map(&qm, q, D, S, B * H, kTmaBQ)
        || !make_map(&km, kb, D, T_ > 0 ? T_ : 1, B * K, kTmaBK)
        || !make_map(&vm, vb, D, T_ > 0 ? T_ : 1, B * K, kTmaBK))
      return cudaErrorInvalidValue;
    constexpr size_t smem = TmaCfg<D>::kSmem;
    auto kern = flash_attention_tma_kernel<D>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((S + kTmaBQ - 1) / kTmaBQ, H, B);
    kern<<<grid, kTmaThreads, smem, s>>>(qm, km, vm, static_cast<T*>(out),
                                         H, K, S, T_, causal, window, sc);
    return cudaGetLastError();
  } else {
    constexpr size_t smem = Cfg<T, D>::kSmem;
    auto kern = flash_attention_kernel<T, D>;
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    kern<<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), H, K, S, T_, causal,
        window, sc);
    return cudaGetLastError();
  }
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
// S >= 1, H and B <= 65535 (grid y and z), contiguity, 16-byte alignment
// and the type (is_bf16: 0 float32, 1 bfloat16).
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
