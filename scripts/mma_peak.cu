// Peak rate of mma.sync on the card: each warp issues `ilp` independent
// m16n8k8 TF32 (or m16n8k16 bf16) products per step, `iters` steps, with
// float32 accumulation. Built and launched by scripts/mma_peak.py.
#include <cuda_runtime.h>
#include <stdint.h>

template <int ILP, bool kBf16>
__global__ void mma_loop(float* out, int iters) {
  float c[ILP][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7,
                 b0 = a0 * 11, b1 = a0 * 13;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < ILP; ++k) {
      if constexpr (kBf16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < ILP; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 1.2345f) out[0] = s;     // keeps the products
}

extern "C" int mma_peak_launch(int bf16, int blocks, int threads, int iters,
                               float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    mma_loop<8, true><<<blocks, threads, 0, s>>>(out, iters);
  else
    mma_loop<8, false><<<blocks, threads, 0, s>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
