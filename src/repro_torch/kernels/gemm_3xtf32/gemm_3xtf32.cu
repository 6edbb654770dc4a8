// float32 matrix product C = A B on Hopper's tensor cores as 3xTF32
// (sm_90a), for the model step's linear products.
//
//   A (M, K), B (K, N)   float32, each row- or column-major (read from its
//                        leading stride: rows 16-byte aligned, no copy)
//   C (M, N)             float32, row-major (or C^T's columns), written
//                        whole
//
// Replaces no TPU kernel. The JAX package leaves its matrix products to
// XLA, which runs float32 on the TPU's matrix unit at full precision; the
// port's equivalent, cuBLAS's float32 GEMM with TF32 off, runs on the
// CUDA cores (67 TFLOP/s at the most), and cuBLAS has no float32-accurate
// tensor-core mode. This kernel computes float32 as 3xTF32, as
// flash_attention.cu and ssd_scan.cu do: each operand x is split into
// big = tf32(x) and small = tf32(x - big) (cvt.rna's rounding), and
// small*big + big*small + big*big are summed in float32 (the small
// terms first).
//
// What bounds it: operations, 3 x 2 M N K on the TF32 tensor cores at 495
// TFLOP/s (165 TFLOP/s of float32 products); at the model step's shapes
// (M 16 384, N and K 256-32 768) that is 4-60x above the bytes' time at
// 3.35 TB/s. What the design does about the rest:
//   - The splits are ALU work beside the products, about 5 instructions
//     an element: every element of a B tile is split once per CTA and of
//     an A tile once by the thread that holds it, and the rounding is two
//     integer operations (the cvt issues at a quarter of their rate).
//     They run in warps of their own, apart from the products: warp 0's
//     lane 0 keeps a ring of 4 stages of raw float32 A and B tiles (32
//     deep in K) in flight with TMA (128-byte swizzle, edges zero-filled
//     by the hardware, so any M, N, K); warps 1-3 split each B tile into
//     TF32 big / small planes, K-major with the 128-byte swizzle (what
//     TF32 wgmma reads), into a ring of 3 plane stages; two consumer
//     warpgroups (64 rows each) split their A fragments from the raw
//     tile into registers (wgmma's A from registers) and issue 4 k-steps
//     x 3 wgmma m64n128k8 a stage, the next stage's A split while this
//     stage's products run. Stages hand over through mbarriers; no
//     CTA-wide barrier runs in the main loop.
//   - The tensor cores add into their accumulator with truncation: summed
//     over the whole K in one accumulator, the products came out 4-19x
//     further from a float64 product than cuBLAS's float32. So each stage
//     starts a fresh accumulator (32 deep) and is added to the running
//     sum in IEEE float32; the result is then 2-20x closer than cuBLAS's
//     at the model step's large products.
//   - A transposed B is the slower split (a 4 x 4 transpose per thread):
//     where both operands' rows are contiguous the wrapper asks for C^T =
//     B^T A^T, whose B is K-major, and the tile is stored transposed.
//   - A persistent grid (one CTA per SM) walks output tiles of 128 x 128
//     in bands of 16 row tiles, so a band's A rows and a wave's B columns
//     stay in L2, and one tile's epilogue overlaps the next one's loads.
//
// Split-K (outputs too few to fill the card, e.g. a weight gradient
// summed over 16 384 tokens into 768 x 256): the wrapper picks the depth;
// each split writes its partial tile to a workspace, and the CTA that
// finishes a tile's last split (an integer ticket per tile, reset by that
// CTA) sums the partials in split order 0, 1, ... and writes C. No float
// atomics: a product repeats bit for bit.
//
// Layouts (PTX ISA): wgmma's A fragment per warp (g = lane / 4, t = lane %
// 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); the
// accumulator d[i] holds (g, 8i + 2t), (g, 8i + 2t + 1), (g + 8, 8i +
// 2t), (g + 8, 8i + 2t + 1). Raw tiles as TMA lands them: a K-major tile
// as rows of 32 floats (128 bytes), chunk c of row r at c ^ (r % 8); an
// MN-major tile as four boxes of 32 x 32 (rows k, 32 floats of M or N).
// Every branch around a wgmma is uniform over the warpgroup.

#include <cuda.h>   // CUtensorMap (the encoder is fetched through the runtime)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kRaw = 4;                  // raw float32 stages (TMA ring)
constexpr int kPlanes = 3;               // B's TF32 plane stages
constexpr int kThreads = 384;            // warp 0 TMA, warps 1-3 split B,
constexpr int kSplitters = 96;           // warps 4-11 two consumer
constexpr int kConsumers = 256;          // warpgroups
constexpr int kTileBytes = kBM * kBK * 4;             // one raw A or B tile
constexpr int kRawBytes = 2 * kTileBytes;
constexpr int kPlaneBytes = 2 * kTileBytes;           // big, small
constexpr int kBarBytes = 8 * 2 * (kRaw + kPlanes) + 8;
constexpr size_t kSmem =
    1024 + (size_t)kRaw * kRawBytes + (size_t)kPlanes * kPlaneBytes
    + kBarBytes;
static_assert(kSmem <= 232448, "the rings must fit in a block's shared "
                               "memory");
constexpr int kGroupM = 16;              // row tiles per band
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- 3xTF32 split -----------------------------------------------------------
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero) as two
// integer operations on the bits: add half the weight of the 13 bits TF32
// drops to the magnitude, clear them (a carry into the exponent rounds
// up, as it should). The cvt instruction issues at a quarter of the
// integer rate, and the splits are this kernel's ALU work.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// Byte offset of (row r, column k < 32) in a block of 128-byte rows with
// the 128-byte swizzle (8-row atoms of 1024 bytes; row r's 16-byte chunk
// c at c ^ (r % 8)), as TMA writes it and wgmma reads it.
__device__ __forceinline__ int swz128(int r, int k) {
  return (r >> 3) * 1024 + (r & 7) * 128 + (((k >> 2) ^ (r & 7)) << 4)
         + (k & 3) * 4;
}
// (row r of M or N, column k) in a raw tile: K-major, or MN-major boxes
template <bool KMAJOR>
__device__ __forceinline__ int raw_off(int r, int k) {
  return KMAJOR ? swz128(r, k) : (r >> 5) * 4096 + swz128(k, r & 31);
}

// ---- mbarriers and TMA --------------------------------------------------------
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
// Wait for the phase of parity `parity` to complete; a pipeline fault
// traps after 2^24 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (n > (1u << 24)) __trap();
  }
}
// box at (c0 inner, c1 outer) of a 2-D tensor map into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma (tf32, m64n128k8, A from registers) ---------------------------------
// descriptor of a K-major 128B-swizzled B: start address, leading byte
// offset 16 (unused with the swizzle), stride byte offset 1024 (the next
// 8 rows), 128-byte swizzle
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
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[16][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
// d (64 x 128) = A (64 x 8, registers) B (128 x 8)^T from shared memory,
// plus d where `accumulate`
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

// ---- the schedule ------------------------------------------------------------
// Work unit u: output tile u / S (in bands of kGroupM row tiles, rows
// fastest within a band) and split u % S, which covers k-blocks [kb0, kb1)
struct Unit {
  int m0, n0, tile, split, kb0, kb1;
};
__device__ __forceinline__ Unit unit_of(int u, int Mt, int Nt, int S,
                                        int nk, int kper) {
  Unit w;
  w.tile = u / S;
  w.split = u - w.tile * S;
  const int band = w.tile / (kGroupM * Nt);
  const int first = band * kGroupM;
  const int rows = min(kGroupM, Mt - first);
  const int in = w.tile - band * kGroupM * Nt;
  w.m0 = (first + in % rows) * kBM;
  w.n0 = (in / rows) * kBN;
  w.kb0 = w.split * kper;
  w.kb1 = min(nk, w.kb0 + kper);
  return w;
}

// B's raw tile (stage) into its TF32 planes, by the 96 splitter threads
template <bool BKM>
__device__ __forceinline__ void split_b(const char* raw, char* big,
                                        int sid) {
  char* small = big + kTileBytes;
  if constexpr (BKM) {
    // same layout on both sides: 16 bytes at a time, the same offsets;
    // four loads in flight a thread
    constexpr int kPer = (kTileBytes / 16 + kSplitters - 1) / kSplitters;
#pragma unroll
    for (int i0 = 0; i0 < kPer; i0 += 4) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = sid + (i0 + j) * kSplitters;
        if (i0 + j < kPer && e < kTileBytes / 16)
          v[j] = *reinterpret_cast<const float4*>(raw + 16 * e);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = sid + (i0 + j) * kSplitters;
        if (i0 + j < kPer && e < kTileBytes / 16) {
          uint4 b, s;
          split(v[j].x, b.x, s.x);
          split(v[j].y, b.y, s.y);
          split(v[j].z, b.z, s.z);
          split(v[j].w, b.w, s.w);
          *reinterpret_cast<uint4*>(big + 16 * e) = b;
          *reinterpret_cast<uint4*>(small + 16 * e) = s;
        }
      }
    }
  } else {
    // N-major boxes to K-major planes: a thread transposes blocks of 4 n
    // x 4 k (unit bits: 0 -> n block bit 0, 1-3 -> k block, 4-7 -> n
    // block bits 1-4, so 8 neighbouring threads read and write mostly
    // distinct 16-byte chunks)
    for (int u = sid; u < (kBN / 4) * (kBK / 4); u += kSplitters) {
      const int n0 = 4 * ((u & 1) | ((u >> 4) << 1));
      const int k0 = 4 * ((u >> 1) & 7);
      float4 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = *reinterpret_cast<const float4*>(raw
                                                + raw_off<false>(n0, k0 + i));
      const float col[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                               {r[0].y, r[1].y, r[2].y, r[3].y},
                               {r[0].z, r[1].z, r[2].z, r[3].z},
                               {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint4 b, s;
        split(col[j][0], b.x, s.x);
        split(col[j][1], b.y, s.y);
        split(col[j][2], b.z, s.z);
        split(col[j][3], b.w, s.w);
        const int off = swz128(n0 + j, k0);
        *reinterpret_cast<uint4*>(big + off) = b;
        *reinterpret_cast<uint4*>(small + off) = s;
      }
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

template <bool AK, bool BKM>
__global__ void __launch_bounds__(kThreads, 1)
gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   float* __restrict__ c, float2* __restrict__ ws,
                   int* __restrict__ tickets, int M, int N, int ldc,
                   int trans_c, int Mt, int Nt, int S, int nk, int kper,
                   int units) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw)
               + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* raw = base;                                   // kRaw x (A, B)
  char* planes = raw + kRaw * kRawBytes;              // kPlanes x (big,
                                                      // small)
  const uint32_t bars = smem_u32(planes + kPlanes * kPlaneBytes);
  auto raw_full = [&](int s) { return bars + 8 * s; };
  auto raw_empty = [&](int s) { return bars + 8 * (kRaw + s); };
  auto plane_full = [&](int p) { return bars + 8 * (2 * kRaw + p); };
  auto plane_empty = [&](int p) {
    return bars + 8 * (2 * kRaw + kPlanes + p);
  };
  int* last_flag = reinterpret_cast<int*>(planes + kPlanes * kPlaneBytes
                                          + 8 * 2 * (kRaw + kPlanes));
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kRaw; ++s) {
      mbar_init(raw_full(s), 1);
      mbar_init(raw_empty(s), kSplitters + kConsumers);
    }
    for (int p = 0; p < kPlanes; ++p) {
      mbar_init(plane_full(p), kSplitters);
      mbar_init(plane_empty(p), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // warpgroup 0 (TMA and splits) gives registers up to the consumers'
    // accumulators and two sets of A fragments
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (tid == 0) {                        // ---- TMA ----
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&amap) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&bmap) : "memory");
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, Mt, Nt, S, nk, kper);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int st = it % kRaw;
          if (it >= kRaw) mbar_wait(raw_empty(st), ((it / kRaw) - 1) & 1);
          const uint32_t a_dst = smem_u32(raw + st * kRawBytes);
          const uint32_t b_dst = a_dst + kTileBytes;
          const uint32_t bar = raw_full(st);
          const int k0 = kb * kBK;
          mbar_expect_tx(bar, kRawBytes);
          if (AK) {
            tma_load_2d(a_dst, &amap, bar, k0, w.m0);
          } else {
            for (int i = 0; i < kBM / 32; ++i)
              tma_load_2d(a_dst + 4096 * i, &amap, bar, w.m0 + 32 * i, k0);
          }
          if (BKM) {
            tma_load_2d(b_dst, &bmap, bar, k0, w.n0);
          } else {
            for (int i = 0; i < kBN / 32; ++i)
              tma_load_2d(b_dst + 4096 * i, &bmap, bar, w.n0 + 32 * i, k0);
          }
        }
      }
    } else if (tid >= 32) {                // ---- B's splitters ----
      const int sid = tid - 32;
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, Mt, Nt, S, nk, kper);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int st = it % kRaw, p = it % kPlanes;
          mbar_wait(raw_full(st), (it / kRaw) & 1);
          if (it >= kPlanes)
            mbar_wait(plane_empty(p), ((it / kPlanes) - 1) & 1);
          split_b<BKM>(raw + st * kRawBytes + kTileBytes,
                       planes + p * kPlaneBytes, sid);
          fence_proxy_async();   // written by threads, read by wgmma
          mbar_arrive(plane_full(p));
          mbar_arrive(raw_empty(st));
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int ct = tid - 128;                  // 0 .. 255
  const int wg = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ra = 64 * wg + 16 * warp + g;    // tile rows of a0 / a1
  const int rb = ra + 8;

  // acc: the unit's running sum, in IEEE float32 adds; part: one stage's
  // 32-deep product on the tensor cores, added to acc once it is done
  float acc[16][4], part[16][4];
  uint32_t ab0[4][4], as0[4][4], ab1[4][4], as1[4][4];
  int it = 0;

  // stage `at`'s A fragments, split into (ab, as); its raw slot freed
  auto load_a = [&](uint32_t (&ab)[4][4], uint32_t (&as)[4][4], int at) {
    const int st = at % kRaw;
    mbar_wait(raw_full(st), (at / kRaw) & 1);
    const char* A = raw + st * kRawBytes;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = 8 * ks + t;
      const float v[4] = {
          *reinterpret_cast<const float*>(A + raw_off<AK>(ra, k)),
          *reinterpret_cast<const float*>(A + raw_off<AK>(rb, k)),
          *reinterpret_cast<const float*>(A + raw_off<AK>(ra, k + 4)),
          *reinterpret_cast<const float*>(A + raw_off<AK>(rb, k + 4))};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], ab[ks][e], as[ks][e]);
    }
    mbar_arrive(raw_empty(st));
  };
  // stage `at`'s 12 products into part (the first one overwrites it)
  auto products = [&](const uint32_t (&ab)[4][4],
                      const uint32_t (&as)[4][4], int at) {
    const int p = at % kPlanes;
    mbar_wait(plane_full(p), (at / kPlanes) & 1);
    const uint32_t big = smem_u32(planes + p * kPlaneBytes);
    const uint32_t small = big + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_tf32(part, as[ks], gmma_desc(big + 32 * ks), ks > 0);
      wgmma_tf32(part, ab[ks], gmma_desc(small + 32 * ks), 1);
      wgmma_tf32(part, ab[ks], gmma_desc(big + 32 * ks), 1);
    }
    wgmma_commit();
  };
  // wait for stage `at`'s products, free its planes, add them up
  auto finish = [&](int at) {
    wgmma_wait0();
    fence_regs(part);
    mbar_arrive(plane_empty(at % kPlanes));
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
  };

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, Mt, Nt, S, nk, kper);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    // the next stage's A is split while this stage's products run
    const int n = w.kb1 - w.kb0;
    load_a(ab0, as0, it);
    for (int j = 0; j < n; j += 2) {
      products(ab0, as0, it);
      if (j + 1 < n) load_a(ab1, as1, it + 1);
      finish(it++);
      if (j + 1 < n) {
        products(ab1, as1, it);
        if (j + 2 < n) load_a(ab0, as0, it + 1);
        finish(it++);
      }
    }

    const int row_a = w.m0 + ra, row_b = w.m0 + rb;
    if (S > 1) {
      // this split's partial, in the fragments' own order (32 float2 a
      // thread, neighbouring threads on neighbouring addresses); rows
      // past M are neither written nor read
      float2* mine = ws + ((size_t)w.tile * S + w.split) * 32 * kConsumers;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (row_a < M)
          mine[(2 * i) * kConsumers + ct] = make_float2(acc[i][0], acc[i][1]);
        if (row_b < M)
          mine[(2 * i + 1) * kConsumers + ct] =
              make_float2(acc[i][2], acc[i][3]);
      }
      __threadfence();
      consumer_sync();
      if (ct == 0) {
        const int before = atomicAdd(tickets + w.tile, 1);
        const int last = before == S - 1;
        if (last) tickets[w.tile] = 0;       // ready for the next launch
        *last_flag = last;
      }
      consumer_sync();
      if (!*last_flag) continue;
      __threadfence();
      // the sum in split order, whichever CTA came last, into acc: every
      // split's partial read back (this one's too), its 32 loads issued
      // together, then added
      const float2* parts = ws + (size_t)w.tile * S * 32 * kConsumers + ct;
      for (int q = 0; q < S; ++q) {
        float2 v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j)
          v[j] = ((j & 1) ? row_b : row_a) < M
                     ? __ldcg(parts + ((size_t)q * 32 + j) * kConsumers)
                     : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int i = j >> 1, h = j & 1;
          acc[i][2 * h] = q ? acc[i][2 * h] + v[j].x : v[j].x;
          acc[i][2 * h + 1] = q ? acc[i][2 * h + 1] + v[j].y : v[j].y;
        }
      }
    }
    // C's rows, 2 columns a store where ldc keeps them 8-byte aligned;
    // trans_c: this tile is C^T's, each column a row of C (lanes g on
    // neighbouring addresses)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = w.n0 + 8 * i + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row_b : row_a;
        if (row >= M) continue;
        const float x = acc[i][2 * h], y = acc[i][2 * h + 1];
        if (trans_c) {
          c[(size_t)col * ldc + row] = x;
          if (col + 1 < N) c[(size_t)(col + 1) * ldc + row] = y;
        } else {
          float* dst = c + (size_t)row * ldc + col;
          if ((ldc & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(x, y);
          } else {
            dst[0] = x;
            if (col + 1 < N) dst[1] = y;
          }
        }
      }
    }
  }
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

// a float32 matrix of `outer` rows of `inner` contiguous elements, row
// stride `ld` elements, read in boxes of 32 x `box_outer` with the
// 128-byte swizzle; elements past either extent read as 0
bool make_map(CUtensorMap* map, const void* base, long long inner,
              long long outer, long long ld, int box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool AK, bool BKM>
cudaError_t launch(const void* a, const void* b, float* c, float2* ws,
                   int* tickets, int M, int N, int K, long long lda,
                   long long ldb, int ldc, int trans_c, int S, int grid,
                   int device, cudaStream_t s) {
  CUtensorMap am, bm;
  if (!make_map(&am, a, AK ? K : M, AK ? M : K, lda, AK ? kBM : 32)
      || !make_map(&bm, b, BKM ? K : N, BKM ? N : K, ldb, BKM ? kBN : 32))
    return cudaErrorInvalidValue;
  auto kern = gemm_3xtf32_kernel<AK, BKM>;
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (attr != cudaSuccess) return attr;
    ready[device] = true;
  }
  const int Mt = (M + kBM - 1) / kBM, Nt = (N + kBN - 1) / kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int kper = (nk + S - 1) / S;
  kern<<<grid, kThreads, kSmem, s>>>(am, bm, c, ws, tickets, M, N, ldc,
                                     trans_c, Mt, Nt, S, nk, kper,
                                     Mt * Nt * S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C = A B (M x N) on `stream`; returns a cudaError_t (0 on success).
// p holds the integer arguments {M, N, K, lda, ldb, ldc, trans_c,
// a_kmajor, b_kmajor, S, grid, device} (one array the wrapper keeps per
// shape, so a launch passes seven pointers). a_kmajor: A's rows (K
// contiguous) are lda apart, else A's columns (M contiguous) are;
// b_kmajor: B's columns (K contiguous) are ldb apart, else B's rows (N
// contiguous) are (not with a_kmajor). C's rows are ldc apart, or with
// trans_c its columns (C^T is written). S > 1 splits K: ws holds M-tiles
// x N-tiles x S x 128 x 128 floats and tickets one int per tile, zero on
// entry (and on return). The wrapper has checked M, N, K >= 1, every
// split non-empty, the strides' and pointers' 16-byte alignment and grid
// <= tiles x S.
int gemm_3xtf32_launch(const void* a, const void* b, void* c, void* ws,
                       void* tickets, void* stream, const long long* p) {
  const int M = (int)p[0], N = (int)p[1], K = (int)p[2];
  const long long lda = p[3], ldb = p[4];
  const int ldc = (int)p[5], trans_c = (int)p[6], a_kmajor = (int)p[7],
            b_kmajor = (int)p[8], S = (int)p[9], grid = (int)p[10],
            device = (int)p[11];
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(c);
  float2* w = static_cast<float2*>(ws);
  int* tk = static_cast<int*>(tickets);
  // (A's rows with B's rows contiguous is never asked for: the wrapper
  // computes C^T = B^T A^T there, the columns of both)
  cudaError_t err;
  if (a_kmajor)
    err = b_kmajor ? launch<true, true>(a, b, cf, w, tk, M, N, K, lda, ldb,
                                        ldc, trans_c, S, grid, device, s)
                   : cudaErrorInvalidValue;
  else
    err = b_kmajor ? launch<false, true>(a, b, cf, w, tk, M, N, K, lda, ldb,
                                         ldc, trans_c, S, grid, device, s)
                   : launch<false, false>(a, b, cf, w, tk, M, N, K, lda,
                                          ldb, ldc, trans_c, S, grid, device,
                                          s);
  return static_cast<int>(err);
}

}  // extern "C"
