// Eval residual-block tail: out = act(((y * a[c]) + b[c]) + skip).
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/residual.py,
// `_fwd_add_kernel` (reached through `fused_bn_add_act` in eval).
//
// Bound on the H100: bytes. y and skip are read once and out written
// once, with a handful of flops per element. At the largest main-path
// site, (16, 65536, 128) in bf16, that is 3 x 268 MB, about 240 us at
// 3.35 TB/s (480 us in f32).
//
// Design: the epilogue kernel's (epilogue.cu) grid-stride loop over the
// (N*H*W, C) row-major block of channels-last tensors, with the skip read
// at the same flat index. The sum is taken in the TPU kernel's order,
// ((y * a) + b) + skip, each step rounded on its own so the plain PyTorch
// version agrees bit for bit for ReLU and Linear.
#include "common.cuh"

namespace helmet {

template <typename T, int ACT>
__global__ void bn_add_act_kernel(const T* __restrict__ y,
                                  const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const T* __restrict__ skip,
                                  T* __restrict__ out, long long n, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % C);
    const float z = __fadd_rn(
        __fadd_rn(__fmul_rn(to_f32(y[i]), a[c]), b[c]), to_f32(skip[i]));
    out[i] = from_f32<T>(activate<ACT>(z));
  }
}

template <typename T>
cudaError_t launch(const void* y, const void* a, const void* b,
                   const void* skip, void* out, long long n, int C, int act,
                   cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = grid_for(n, threads);
  const T* yp = static_cast<const T*>(y);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const T* sp = static_cast<const T*>(skip);
  T* op = static_cast<T*>(out);
  switch (act) {
    case kReLU:
      bn_add_act_kernel<T, kReLU><<<blocks, threads, 0, stream>>>(yp, ap, bp, sp, op, n, C);
      break;
    case kMish:
      bn_add_act_kernel<T, kMish><<<blocks, threads, 0, stream>>>(yp, ap, bp, sp, op, n, C);
      break;
    case kLinear:
      bn_add_act_kernel<T, kLinear><<<blocks, threads, 0, stream>>>(yp, ap, bp, sp, op, n, C);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace helmet

extern "C" int helmet_bn_add_act(const void* y, const void* a, const void* b,
                                 const void* skip, void* out, long long n,
                                 int C, int dtype, int act, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::launch<float>(y, a, b, skip, out, n, C, act, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::launch<__nv_bfloat16>(y, a, b, skip, out, n, C, act, s);
  return (int)cudaErrorInvalidValue;
}
