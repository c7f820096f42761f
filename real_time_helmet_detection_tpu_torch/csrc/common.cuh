// Helpers shared by the pointwise BN epilogue kernels (epilogue.cu,
// residual.cu): element load/store in f32 math for f32 or bf16 storage,
// and the three activations the port supports.
//
// Rounding rule: every product and sum goes through the __f*_rn
// intrinsics, so nvcc cannot contract `x * a + b` into one FMA. The plain
// PyTorch versions run the same operations as separate eager kernels,
// each rounded on its own, and ReLU/Linear then agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace helmet {

enum Dtype : int { kF32 = 0, kBF16 = 1 };
enum Act : int { kReLU = 0, kMish = 1, kLinear = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if (ACT == kReLU) return z < 0.f ? 0.f : z;  // NaN propagates
  if (ACT == kMish) return __fmul_rn(z, tanhf(log1pf(expf(z))));
  return z;
}

// Blocks for a grid-stride loop over n elements: enough to fill 132 SMs
// several times over, never more than the work needs.
inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace helmet
