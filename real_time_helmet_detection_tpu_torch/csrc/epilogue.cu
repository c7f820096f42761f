// Eval BatchNorm + activation epilogue: out = act(x * a[c] + b[c]).
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/epilogue.py,
// `_fwd_kernel` (reached through `fused_bn_act` in eval).
//
// Bound on the H100: bytes. Each element is read once and written once,
// with 2-3 flops (ReLU/Linear) or a few transcendentals (Mish) per
// element, far below the 295 flops per byte where the card turns
// compute-bound. At the largest main-path site, (16, 65536, 128) in bf16,
// that is 2 x 268 MB, about 160 us at 3.35 TB/s (320 us in f32).
//
// Design: the tensor is the (N*H*W, C) row-major block of a channels-last
// NCHW tensor, so the channel of flat element i is i % C and the
// per-channel a[c], b[c] (C floats, L1-resident) broadcast with no
// relayout. One grid-stride loop, one element per thread per step,
// neighbouring threads on neighbouring addresses (coalesced). f32 math in
// registers whatever the storage type; nothing is saved for a backward.
// Vector loads of 8 bf16 per thread are the obvious next step.
#include "common.cuh"

namespace helmet {

template <typename T, int ACT>
__global__ void bn_act_kernel(const T* __restrict__ x,
                              const float* __restrict__ a,
                              const float* __restrict__ b,
                              T* __restrict__ out, long long n, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % C);
    const float z = __fadd_rn(__fmul_rn(to_f32(x[i]), a[c]), b[c]);
    out[i] = from_f32<T>(activate<ACT>(z));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* b, void* out,
                   long long n, int C, int act, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
  const T* xp = static_cast<const T*>(x);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  T* op = static_cast<T*>(out);
  switch (act) {
    case kReLU:
      bn_act_kernel<T, kReLU><<<blocks, threads, 0, stream>>>(xp, ap, bp, op, n, C);
      break;
    case kMish:
      bn_act_kernel<T, kMish><<<blocks, threads, 0, stream>>>(xp, ap, bp, op, n, C);
      break;
    case kLinear:
      bn_act_kernel<T, kLinear><<<blocks, threads, 0, stream>>>(xp, ap, bp, op, n, C);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace helmet

extern "C" int helmet_bn_act(const void* x, const void* a, const void* b,
                             void* out, long long n, int C, int dtype, int act,
                             void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::launch<float>(x, a, b, out, n, C, act, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::launch<__nv_bfloat16>(x, a, b, out, n, C, act, s);
  return (int)cudaErrorInvalidValue;
}
