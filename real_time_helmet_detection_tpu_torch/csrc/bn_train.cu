// BatchNorm backward passes on the card: the train-mode batch moments and
// analytic backward of BN + activation, with or without the residual
// skip-add, and the one-pass backward of the eval-mode (running-statistics)
// epilogue and tail.
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/epilogue.py,
// `_stats_kernel`, `_bwd_sums_kernel`, `_bwd_dx_kernel` (reached through
// `fused_bn_act_train`) and `_bwd_kernel` (the eval backward of
// `fused_bn_act`), and ops/pallas/residual.py, `_bwd_add_sums_kernel` and
// `_bwd_add_dx_kernel` (reached through `fused_bn_add_act_train`) and
// `_bwd_add_kernel` (the eval backward of `fused_bn_add_act`). The backward
// kernels are templated on HAS_SKIP: the skip shifts z and receives
// ds = dz, nothing else changes.
//
//   bn_stats      partials of sum(x), sum(x^2) per channel
//   bn_bwd_sums   z = x*a + b (+ s), dz = g * act'(z); partials of
//                 S1 = sum(dz), S2 = sum(dz * x)
//   bn_bwd_dx     dx = a*dz - k2*x - k1 (and ds = dz)
//   eval          the sums pass that also writes dx = dz*a (and ds = dz):
//                 with the running statistics folded into (a, b) nothing
//                 depends on the sums, so one pass gives dx and the
//                 partials of d(eff_bias) = S1, d(eff_scale) = S2, as the
//                 TPU kernels do
//
// Bound on the H100: bytes. Each pass reads its activation-sized operands
// once (stats: x; sums: x, g (, s); dx: x, g (, s), writing dx (, ds);
// eval: x, g (, s), writing dx (, ds)) with a handful of flops per
// element. At the largest main-path site, (16, 65536, 128) in bf16, one
// operand is 268 MB: stats 80 us, sums 160 (skip 240) us, dx and eval 240
// (skip 400) us at 3.35 TB/s; twice that in f32.
//
// Design: every tensor is the (rows, C) row-major block of a channels-last
// NCHW tensor. A thread owns one channel PAIR (one bf16x2 or float2 load,
// neighbouring threads on neighbouring addresses) and walks a strided run
// of rows; block (C/2 x rows-lanes) threads cover a contiguous chunk of
// rows. The reductions are two-stage with no float atomics: each block
// sums its row lanes in shared memory in a fixed order and writes one
// (C,) partial row; the wrapper sums the partials with torch. Runs
// reproduce bit for bit. Pointwise math goes through the __f*_rn
// intrinsics in the JAX formulas' order, so `dx` matches the plain PyTorch
// version bit for bit given the same a, b, k1, k2.
#include "common.cuh"

namespace helmet {

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type from_f32x2(float2 v);
template <>
__device__ __forceinline__ float2 from_f32x2<float>(float2 v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat162 from_f32x2<__nv_bfloat16>(
    float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}

constexpr int kThreads = 256;

// z = ((x * a) + b) (+ s), each step rounded on its own (the TPU kernels'
// order, ref residual.py:115)
template <bool HAS_SKIP>
__device__ __forceinline__ float pre_act(float x, float a, float b,
                                         float s) {
  const float z = __fadd_rn(__fmul_rn(x, a), b);
  return HAS_SKIP ? __fadd_rn(z, s) : z;
}

// The block's row chunk: rows [r0, r1) of `rows`, chunks of
// ceil(rows / gridDim.x); a trailing block may be empty and then writes
// zero partials.
__device__ __forceinline__ void row_chunk(long long rows, long long* r0,
                                          long long* r1) {
  const long long per = (rows + gridDim.x - 1) / gridDim.x;
  *r0 = (long long)blockIdx.x * per;
  *r1 = *r0 + per < rows ? *r0 + per : rows;
}

// Sum (u, v) over the block's row lanes (threadIdx.y) in a fixed order and
// write the block's partials of channels 2p, 2p+1.
__device__ __forceinline__ void reduce_write(float2 u, float2 v, int p,
                                             bool active, float* part_u,
                                             float* part_v, int C) {
  __shared__ float2 su[kThreads];
  __shared__ float2 sv[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y, tw = blockDim.x;
  su[ty * tw + tx] = u;
  sv[ty * tw + tx] = v;
  __syncthreads();
  if (ty == 0 && active) {
    float2 tu = su[tx], tv = sv[tx];
    for (int j = 1; j < (int)blockDim.y; ++j) {
      const float2 a = su[j * tw + tx], b = sv[j * tw + tx];
      tu.x = __fadd_rn(tu.x, a.x);
      tu.y = __fadd_rn(tu.y, a.y);
      tv.x = __fadd_rn(tv.x, b.x);
      tv.y = __fadd_rn(tv.y, b.y);
    }
    const long long o = (long long)blockIdx.x * C + 2 * p;
    part_u[o] = tu.x;
    part_u[o + 1] = tu.y;
    part_v[o] = tv.x;
    part_v[o + 1] = tv.y;
  }
  __syncthreads();  // the next channel group reuses the shared arrays
}

template <typename T>
__global__ void bn_stats_kernel(const T* __restrict__ x,
                                float* __restrict__ s_part,
                                float* __restrict__ ss_part, long long rows,
                                int C) {
  using V = typename Vec2<T>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  const int cp = C / 2;
  long long r0, r1;
  row_chunk(rows, &r0, &r1);
  for (int p0 = 0; p0 < cp; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < cp;
    float2 s = make_float2(0.f, 0.f), ss = make_float2(0.f, 0.f);
    if (active) {
      for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
        const float2 v = to_f32x2(xv[r * cp + p]);
        s.x = __fadd_rn(s.x, v.x);
        s.y = __fadd_rn(s.y, v.y);
        ss.x = __fadd_rn(ss.x, __fmul_rn(v.x, v.x));
        ss.y = __fadd_rn(ss.y, __fmul_rn(v.y, v.y));
      }
    }
    reduce_write(s, ss, p, active, s_part, ss_part, C);
  }
}

// WRITE_DX: the eval backward, which also stores dx = dz*a (and ds = dz)
// from the same loads.
template <typename T, int ACT, bool HAS_SKIP, bool WRITE_DX>
__global__ void bn_bwd_sums_kernel(const T* __restrict__ x,
                                   const T* __restrict__ skip,
                                   const T* __restrict__ g,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   float* __restrict__ s1_part,
                                   float* __restrict__ s2_part,
                                   T* __restrict__ dx, T* __restrict__ ds,
                                   long long rows, int C) {
  using V = typename Vec2<T>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* sv = reinterpret_cast<const V*>(skip);
  const V* gv = reinterpret_cast<const V*>(g);
  V* dxv = reinterpret_cast<V*>(dx);
  V* dsv = reinterpret_cast<V*>(ds);
  const int cp = C / 2;
  long long r0, r1;
  row_chunk(rows, &r0, &r1);
  for (int p0 = 0; p0 < cp; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool active = p < cp;
    float2 s1 = make_float2(0.f, 0.f), s2 = make_float2(0.f, 0.f);
    if (active) {
      const float a0 = a[2 * p], a1 = a[2 * p + 1];
      const float b0 = b[2 * p], b1 = b[2 * p + 1];
      for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
        const long long i = r * cp + p;
        const float2 xf = to_f32x2(xv[i]);
        const float2 gf = to_f32x2(gv[i]);
        const float2 sf = HAS_SKIP ? to_f32x2(sv[i]) : make_float2(0.f, 0.f);
        const float dz0 = __fmul_rn(
            gf.x, activate_grad<ACT>(pre_act<HAS_SKIP>(xf.x, a0, b0, sf.x)));
        const float dz1 = __fmul_rn(
            gf.y, activate_grad<ACT>(pre_act<HAS_SKIP>(xf.y, a1, b1, sf.y)));
        s1.x = __fadd_rn(s1.x, dz0);
        s1.y = __fadd_rn(s1.y, dz1);
        s2.x = __fadd_rn(s2.x, __fmul_rn(dz0, xf.x));
        s2.y = __fadd_rn(s2.y, __fmul_rn(dz1, xf.y));
        if (WRITE_DX) {
          // dz * a, the order of ref epilogue.py:152
          dxv[i] = from_f32x2<T>(make_float2(__fmul_rn(dz0, a0),
                                             __fmul_rn(dz1, a1)));
          if (HAS_SKIP) dsv[i] = from_f32x2<T>(make_float2(dz0, dz1));
        }
      }
    }
    reduce_write(s1, s2, p, active, s1_part, s2_part, C);
  }
}

template <typename T, int ACT, bool HAS_SKIP>
__global__ void bn_bwd_dx_kernel(const T* __restrict__ x,
                                 const T* __restrict__ skip,
                                 const T* __restrict__ g,
                                 const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 const float* __restrict__ k1,
                                 const float* __restrict__ k2,
                                 T* __restrict__ dx, T* __restrict__ ds,
                                 long long npairs, int C) {
  using V = typename Vec2<T>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* sv = reinterpret_cast<const V*>(skip);
  const V* gv = reinterpret_cast<const V*>(g);
  V* dxv = reinterpret_cast<V*>(dx);
  V* dsv = reinterpret_cast<V*>(ds);
  const int cp = C / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < npairs; i += stride) {
    const int c = 2 * (int)(i % cp);
    const float2 xf = to_f32x2(xv[i]);
    const float2 gf = to_f32x2(gv[i]);
    const float2 sf = HAS_SKIP ? to_f32x2(sv[i]) : make_float2(0.f, 0.f);
    float2 dz, out;
    dz.x = __fmul_rn(gf.x, activate_grad<ACT>(
                               pre_act<HAS_SKIP>(xf.x, a[c], b[c], sf.x)));
    dz.y = __fmul_rn(gf.y, activate_grad<ACT>(pre_act<HAS_SKIP>(
                               xf.y, a[c + 1], b[c + 1], sf.y)));
    // ((a * dz) - (k2 * x)) - k1, the order of ref epilogue.py:445
    out.x = __fsub_rn(__fsub_rn(__fmul_rn(a[c], dz.x), __fmul_rn(k2[c], xf.x)),
                      k1[c]);
    out.y = __fsub_rn(
        __fsub_rn(__fmul_rn(a[c + 1], dz.y), __fmul_rn(k2[c + 1], xf.y)),
        k1[c + 1]);
    dxv[i] = from_f32x2<T>(out);
    if (HAS_SKIP) dsv[i] = from_f32x2<T>(dz);
  }
}

inline dim3 reduce_block(int C) {
  const int cp = C / 2;
  const int tx = cp < kThreads ? cp : kThreads;
  return dim3(tx, kThreads / tx);
}

// dx == NULL: the train sums pass; else the eval backward, which also
// writes dx (and ds when the skip is given)
template <typename T, int ACT>
cudaError_t launch_sums(const void* x, const void* skip, const void* g,
                        const void* a, const void* b, void* s1, void* s2,
                        void* dx, void* ds, long long rows, int C,
                        int nblocks, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(skip);
  const T* gp = static_cast<const T*>(g);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* s1p = static_cast<float*>(s1);
  float* s2p = static_cast<float*>(s2);
  T* dxp = static_cast<T*>(dx);
  T* dsp = static_cast<T*>(ds);
  const dim3 block = reduce_block(C);
  if (skip != nullptr && dx != nullptr)
    bn_bwd_sums_kernel<T, ACT, true, true><<<nblocks, block, 0, stream>>>(
        xp, sp, gp, ap, bp, s1p, s2p, dxp, dsp, rows, C);
  else if (dx != nullptr)
    bn_bwd_sums_kernel<T, ACT, false, true><<<nblocks, block, 0, stream>>>(
        xp, sp, gp, ap, bp, s1p, s2p, dxp, dsp, rows, C);
  else if (skip != nullptr)
    bn_bwd_sums_kernel<T, ACT, true, false><<<nblocks, block, 0, stream>>>(
        xp, sp, gp, ap, bp, s1p, s2p, dxp, dsp, rows, C);
  else
    bn_bwd_sums_kernel<T, ACT, false, false><<<nblocks, block, 0, stream>>>(
        xp, sp, gp, ap, bp, s1p, s2p, dxp, dsp, rows, C);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_dx(const void* x, const void* skip, const void* g,
                      const void* a, const void* b, const void* k1,
                      const void* k2, void* dx, void* ds, long long rows,
                      int C, cudaStream_t stream) {
  const long long npairs = rows * (C / 2);
  const unsigned blocks = grid_for(npairs, kThreads);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(skip);
  const T* gp = static_cast<const T*>(g);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  const float* k1p = static_cast<const float*>(k1);
  const float* k2p = static_cast<const float*>(k2);
  T* dxp = static_cast<T*>(dx);
  T* dsp = static_cast<T*>(ds);
  if (skip != nullptr)
    bn_bwd_dx_kernel<T, ACT, true><<<blocks, kThreads, 0, stream>>>(
        xp, sp, gp, ap, bp, k1p, k2p, dxp, dsp, npairs, C);
  else
    bn_bwd_dx_kernel<T, ACT, false><<<blocks, kThreads, 0, stream>>>(
        xp, sp, gp, ap, bp, k1p, k2p, dxp, dsp, npairs, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_sums(int act, const void* x, const void* skip,
                          const void* g, const void* a, const void* b,
                          void* s1, void* s2, void* dx, void* ds,
                          long long rows, int C, int nblocks,
                          cudaStream_t stream) {
  switch (act) {
    case kReLU:
      return launch_sums<T, kReLU>(x, skip, g, a, b, s1, s2, dx, ds, rows, C,
                                   nblocks, stream);
    case kMish:
      return launch_sums<T, kMish>(x, skip, g, a, b, s1, s2, dx, ds, rows, C,
                                   nblocks, stream);
    case kLinear:
      return launch_sums<T, kLinear>(x, skip, g, a, b, s1, s2, dx, ds, rows,
                                     C, nblocks, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dx(int act, const void* x, const void* skip,
                        const void* g, const void* a, const void* b,
                        const void* k1, const void* k2, void* dx, void* ds,
                        long long rows, int C, cudaStream_t stream) {
  switch (act) {
    case kReLU:
      return launch_dx<T, kReLU>(x, skip, g, a, b, k1, k2, dx, ds, rows, C,
                                 stream);
    case kMish:
      return launch_dx<T, kMish>(x, skip, g, a, b, k1, k2, dx, ds, rows, C,
                                 stream);
    case kLinear:
      return launch_dx<T, kLinear>(x, skip, g, a, b, k1, k2, dx, ds, rows, C,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace helmet

// Every entry takes rows = N*H*W and an even channel count C; `skip` (and
// `ds`) may be NULL, which selects the kernels without a skip operand.
extern "C" int helmet_bn_stats(const void* x, void* s_part, void* ss_part,
                               long long rows, int C, int nblocks, int dtype,
                               void* stream) {
  if (rows <= 0 || C <= 0 || C % 2 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block = helmet::reduce_block(C);
  float* sp = static_cast<float*>(s_part);
  float* ssp = static_cast<float*>(ss_part);
  if (dtype == helmet::kF32)
    helmet::bn_stats_kernel<float><<<nblocks, block, 0, s>>>(
        static_cast<const float*>(x), sp, ssp, rows, C);
  else if (dtype == helmet::kBF16)
    helmet::bn_stats_kernel<__nv_bfloat16><<<nblocks, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sp, ssp, rows, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dx == NULL: the train sums pass. Else the eval backward, which also
// writes dx (and ds, given with the skip) from the same loads; its
// partials of d(eff_bias) = sum(dz) and d(eff_scale) = sum(dz * x) are
// s1_part and s2_part.
extern "C" int helmet_bn_bwd_sums(const void* x, const void* skip,
                                  const void* g, const void* a, const void* b,
                                  void* s1_part, void* s2_part, void* dx,
                                  void* ds, long long rows, int C,
                                  int nblocks, int dtype, int act,
                                  void* stream) {
  if (rows <= 0 || C <= 0 || C % 2 || nblocks <= 0 ||
      (dx != nullptr && (skip != nullptr) != (ds != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::dispatch_sums<float>(act, x, skip, g, a, b, s1_part,
                                             s2_part, dx, ds, rows, C,
                                             nblocks, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::dispatch_sums<__nv_bfloat16>(
        act, x, skip, g, a, b, s1_part, s2_part, dx, ds, rows, C, nblocks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int helmet_bn_bwd_dx(const void* x, const void* skip,
                                const void* g, const void* a, const void* b,
                                const void* k1, const void* k2, void* dx,
                                void* ds, long long rows, int C, int dtype,
                                int act, void* stream) {
  if (rows <= 0 || C <= 0 || C % 2 || (skip != nullptr && ds == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::dispatch_dx<float>(act, x, skip, g, a, b, k1, k2, dx,
                                           ds, rows, C, s);
  if (dtype == helmet::kBF16)
    return (int)helmet::dispatch_dx<__nv_bfloat16>(act, x, skip, g, a, b, k1,
                                                   k2, dx, ds, rows, C, s);
  return (int)cudaErrorInvalidValue;
}

