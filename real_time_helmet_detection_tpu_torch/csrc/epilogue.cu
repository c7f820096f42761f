// Eval BatchNorm + activation epilogue: out = act(x * a[c] + b[c]).
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/epilogue.py,
// `_fwd_kernel` (reached through `fused_bn_act`, eval and train).
//
// Bound on the H100: bytes. Each element is read once and written once,
// with 2-3 flops (ReLU/Linear) or a few transcendentals (Mish) per
// element, far below the 295 flops per byte where the card turns
// compute-bound. At the largest main-path site, (16, 65536, 128) in bf16,
// that is 2 x 268 MB, about 160 us at 3.35 TB/s (320 us in f32); the
// 256^2 sites never fit the 50 MB L2.
//
// The tensor is the (N*H*W, C) row-major block of a channels-last NCHW
// tensor, so the channel of flat element i is i % C and the per-channel
// a[c], b[c] broadcast with no relayout.
//
// Design (bn_act_vec_kernel, the main path): HBM stays busy only with
// enough bytes in flight, so each thread moves 16 bytes per access (8
// bf16 or 4 f32: V values of one channel group) and issues kUnroll
// independent accesses before it uses any. With C % V == 0 the block size
// and the grid stride are multiples of G = C / V, so every access of a
// thread covers the same V channels: the thread reads its V values of a
// and b into registers once, and the loop has no `%` and no gather. Loads
// and stores carry the streaming hint (ld.global.cs / st.global.cs): the
// data is touched once. The grid is one wave of resident blocks (the
// occupancy API x the SM count), capped by the work, so the small sites
// launch only the blocks they need. Per element the rounding is the
// scalar kernel's: __fmul_rn, __fadd_rn, activate<ACT>, one rounding to
// the storage type, so ReLU/Linear agree bit for bit with the plain
// PyTorch version.
//
// bn_act_kernel is the earlier scalar form (one element per thread per
// step, i % C and two gathers per element). The wrapper launches it for
// the shapes the vector kernel cannot take: C % V != 0, C / V > 256, or
// x or out not 16-byte aligned.
#include <stdint.h>

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

// 16 bytes of storage <-> V floats, exactly (bf16 -> f32 is a shift)
template <typename T>
struct Pack16;
template <>
struct Pack16<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void split(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned join(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ void unpack(uint4 u, float* f) {
    split(u.x, f);
    split(u.y, f + 2);
    split(u.z, f + 4);
    split(u.w, f + 6);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(join(f[0], f[1]), join(f[2], f[3]), join(f[4], f[5]),
                      join(f[6], f[7]));
  }
};

constexpr int kUnroll = 4;
constexpr int kVecThreads = 256;  // rounded down to a multiple of G
constexpr int kMaxGroups = kVecThreads;  // G = C / V at most

template <typename T, int ACT>
__device__ __forceinline__ uint4 bn_act16(uint4 u, const float* av,
                                          const float* bv) {
  constexpr int V = Pack16<T>::V;
  float f[V];
  Pack16<T>::unpack(u, f);
#pragma unroll
  for (int k = 0; k < V; ++k)
    f[k] = activate<ACT>(__fadd_rn(__fmul_rn(f[k], av[k]), bv[k]));
  return Pack16<T>::pack(f);
}

// nvec 16-byte vectors; G = C / V channel groups per row; blockDim.x is a
// multiple of G, so threadIdx.x % G is the group of every access
template <typename T, int ACT>
__global__ void __launch_bounds__(kVecThreads)
    bn_act_vec_kernel(const uint4* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ b, uint4* __restrict__ out,
                      long long nvec, int G) {
  constexpr int V = Pack16<T>::V;
  const int c0 = (threadIdx.x % G) * V;
  float av[V], bv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    av[k] = a[c0 + k];
    bv[k] = b[c0 + k];
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      __stcs(out + i + u * stride, bn_act16<T, ACT>(v[u], av, bv));
  }
  for (; i < nvec; i += stride)
    __stcs(out + i, bn_act16<T, ACT>(__ldcs(x + i), av, bv));
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

template <typename T, int ACT>
cudaError_t launch_vec_act(const void* x, const void* a, const void* b,
                           void* out, long long nvec, int G,
                           cudaStream_t stream) {
  const auto kernel = bn_act_vec_kernel<T, ACT>;
  const int threads = G * (kVecThreads / G);
  int per_sm = 0;
  const cudaError_t e = launch_setup(reinterpret_cast<const void*>(kernel),
                                     threads, 0, &per_sm);
  if (e != cudaSuccess) return e;
  const unsigned blocks = wave_grid(per_sm, (nvec + threads - 1) / threads);
  kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<uint4*>(out), nvec, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* x, const void* a, const void* b, void* out,
                       long long n, int C, int act, cudaStream_t stream) {
  constexpr int V = Pack16<T>::V;
  if (C % V != 0 || C / V > kMaxGroups ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
              16 != 0)
    return cudaErrorInvalidValue;
  const long long nvec = n / V;
  const int G = C / V;
  switch (act) {
    case kReLU:
      return launch_vec_act<T, kReLU>(x, a, b, out, nvec, G, stream);
    case kMish:
      return launch_vec_act<T, kMish>(x, a, b, out, nvec, G, stream);
    case kLinear:
      return launch_vec_act<T, kLinear>(x, a, b, out, nvec, G, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace helmet

// The scalar kernel: any C, any alignment of the storage type.
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

// The vector kernel: C a multiple of V (8 bf16, 4 f32) with C / V <= 256,
// x and out 16-byte aligned; anything else is refused, not run.
extern "C" int helmet_bn_act_vec(const void* x, const void* a, const void* b,
                                 void* out, long long n, int C, int dtype,
                                 int act, void* stream) {
  if (n <= 0 || C <= 0 || n % C != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::launch_vec<float>(x, a, b, out, n, C, act, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::launch_vec<__nv_bfloat16>(x, a, b, out, n, C, act, s);
  return (int)cudaErrorInvalidValue;
}
