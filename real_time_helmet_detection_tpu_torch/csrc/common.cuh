// Helpers shared by the kernels (epilogue.cu, residual.cu, bn_train.cu,
// loss.cu, peak.cu): element load/store in f32 math for f32 or bf16 storage,
// the three activations the port supports and their derivatives, and the
// grid sizes and per-device launch set-up of the kernels.
//
// Rounding rule: every product and sum goes through the __f*_rn
// intrinsics, so nvcc cannot contract `x * a + b` into one FMA. The plain
// PyTorch versions run the same operations as separate eager kernels,
// each rounded on its own, and ReLU/Linear then agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace helmet {

enum Dtype : int { kF32 = 0, kBF16 = 1 };

// dynamic shared memory a block may opt into on the H100
constexpr int kMaxDynamicSmem = 227 * 1024;
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

// d act(z) / dz, recomputed from z (ref ops/pallas/epilogue.py:109
// `_act_grad`): ReLU is 0 at the tie z == 0; Mish is
// t + z * (1 - t^2) * sigmoid(z) with t = tanh(softplus(z)) and sigmoid
// as ATen computes it, 1 / (1 + exp(-z)).
template <int ACT>
__device__ __forceinline__ float activate_grad(float z) {
  if (ACT == kReLU) return z > 0.f ? 1.f : 0.f;
  if (ACT == kMish) {
    const float t = tanhf(log1pf(expf(z)));
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
    return __fadd_rn(
        t, __fmul_rn(__fmul_rn(z, __fsub_rn(1.f, __fmul_rn(t, t))), sig));
  }
  return 1.f;
}

// Blocks for a grid-stride loop over n elements: enough to fill 132 SMs
// several times over, never more than the work needs.
inline unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  const long long cap = 132LL * 16;
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// Blocks for a grid-stride loop that needs `needed` blocks to give every
// thread one step: at most one wave of resident blocks, `per_sm` (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) on each SM of the
// current device.
inline unsigned wave_grid(int per_sm, long long needed) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(needed < 1 ? 1 : needed < wave ? needed : wave);
}

// Launch set-up of `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory on the current device: opts the kernel into up to
// kMaxDynamicSmem where smem passes the default 48 KB (the attribute
// applies to one device only) and gives its resident blocks per SM. Done
// once per device, kernel and size, under a lock; later calls read the
// cache, so a launch inside a CUDA-graph capture makes no set-up call.
inline cudaError_t launch_setup(const void* kernel, int threads, int smem,
                                int* per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, kernel, threads, smem);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  cache.emplace(key, *per_sm);
  return cudaSuccess;
}

}  // namespace helmet
