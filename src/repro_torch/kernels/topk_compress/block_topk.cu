// Block top-1 sparsification for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_topk_kernel`
// (src/repro/kernels/topk_compress/topk_compress.py, launched by
// `block_topk_pallas` through `ops.py::block_topk`): keep the first
// max-|.| entry of every contiguous W-entry run of a flat buffer and zero
// the rest, in the input's type (float32 or bfloat16).
//
//   x  (n,)  flat input; rows of W, the last one read as zeros past n
//   y  (n,)  same type: one entry kept per row, +0 elsewhere
//
// Semantics kept bit for bit from the Pallas body (not from the JAX
// package's numpy oracle, which keeps a NaN):
//   - the first max wins: among |x| == max, the lowest column;
//   - a row that holds a NaN comes out all zeros (max |.| is NaN and
//     `mag >= NaN` is false everywhere);
//   - the kept entry is written as it was read, sign bit included, so an
//     all-zero row keeps x[0] even when it is -0.0; +-inf is kept;
//   - the zero tail padding takes part as zeros and never wins (a real
//     column precedes it and wins the tie).
//
// What bounds it on the card: bytes. It reads each entry once and writes
// each entry once, with an abs and a compare in between: the floor is
// 2 n sizeof(T) over HBM bandwidth. The design:
//   - one warp per row; lane l walks columns l, l+32, ... in groups of 4
//     loads issued together, so any W works (no cap) and each load
//     instruction of the warp reads 32 contiguous entries;
//   - each lane keeps a running (|v|, column, v) best with a strict `>`
//     over increasing columns, then a 5-step xor-shuffle reduction under
//     the total order (|v| descending, column ascending) leaves every
//     lane holding the row's winner and its value;
//   - a NaN anywhere is found with one `__any_sync`;
//   - one write pass stores the row: the winner's value at its column,
//     zeros elsewhere; the row is not read twice;
//   - a grid-stride loop over rows with 8 warps per block.
// Vector loads and several rows per warp for small W come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // exact: x came from a bfloat16
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_topk_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                  int W, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock
                       + (threadIdx.x >> 5);
       row < rows; row += warps) {
    const long long base = row * (long long)W;
    const long long left = n - base;                // real columns: < left
    float bm = -1.0f;                               // below any |v|
    int bi = INT_MAX;
    float bv = 0.0f;
    bool nan_here = false;
    for (int c0 = 0; c0 < W; c0 += 32 * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = c0 + lane + 32 * u;
        v[u] = (j < W && j < left) ? to_f32(x[base + j]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = c0 + lane + 32 * u;
        if (j < W) {
          const float m = fabsf(v[u]);
          nan_here |= isnan(v[u]);
          if (m > bm) {
            bm = m;
            bi = j;
            bv = v[u];
          }
        }
      }
    }
    const bool row_nan = __any_sync(kFull, nan_here);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(kFull, bm, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const float ov = __shfl_xor_sync(kFull, bv, off);
      if (om > bm || (om == bm && oi < bi)) {
        bm = om;
        bi = oi;
        bv = ov;
      }
    }
    const T kept = from_f32<T>(bv);
    const T zero = from_f32<T>(0.0f);
    for (int j = lane; j < W && j < left; j += 32) {
      y[base + j] = (!row_nan && j == bi) ? kept : zero;
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, int W,
                   cudaStream_t s) {
  const long long rows = (n + W - 1) / W;
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 132LL * 64) blocks = 132LL * 64;     // grid-stride past this
  block_topk_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, W, rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` of card `device`; returns a cudaError_t (0 on
// success). The wrapper has checked n >= 1, W >= 1 and the type
// (is_bf16: 0 float32, 1 bfloat16).
int block_topk_launch(const void* x, void* y, long long n, int W,
                      int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, y, n, W, s)
              : launch<float>(x, y, n, W, s);
  return static_cast<int>(err);
}

}  // extern "C"
