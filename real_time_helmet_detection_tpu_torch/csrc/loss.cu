// Fused sigmoid + focal + masked-L1 detection loss: the per-(stack, sample)
// sums of the forward and the recompute backward.
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/loss.py, `_fwd_kernel`
// and `_bwd_kernel` (reached through `fused_stack_loss_sums` and
// `fused_detection_loss`).
//
//   loss_fwd   four sums per (stack s, sample b) of the raw output
//              out (B, S, H, W, C+4): focal positive and negative log terms
//              over (H, W, C), before negation and normalisation, and the
//              masked L1 of offset and size over (H, W, 2)
//   loss_bwd   d(out) from four (S, B) cotangents, the forward terms
//              recomputed from the same inputs
//
// Bound on the H100: bytes, and at the main path's size launch latency.
// The forward reads out (B, S, H, W, C+4) and the targets heat (B, H, W, C),
// off, wh (B, H, W, 2), mask (B, H, W, 1) once; the backward reads the same
// and writes dout once. At b16 128^2, C = 2, f32: 13.6 MB and 19.9 MB, 4.1
// and 5.9 us at 3.35 TB/s; a few dozen flops per element.
//
// Design: the TPU grid has one program per (stack, sample), 16 at b16; here
// a block covers one tile of kTilePixels pixels of one (s, b) map, so the
// flagship runs 16 x 16 blocks. `out` stays in the model's (B, S, ...)
// layout: the (stack, sample) swap is in the indexing, as the Pallas index
// maps do it. A thread walks pixels of its tile and reads each pixel's C+4
// logits and its targets; neighbouring threads read neighbouring pixels.
// The forward sums its tile in shared memory in a fixed tree order and
// writes one partial per (quantity, s, b, tile); the wrapper folds the
// tiles with torch in a fixed order. No float atomics: runs reproduce bit
// for bit. The backward needs no reduction and writes dout once. Math is
// f32 through the __f*_rn intrinsics in the Pallas kernels' order; the
// sigmoid is ATen's 1 / (1 + expf(-x)) and x**e for a scalar exponent
// follows ATen's CUDA pow(Tensor, Scalar) (0, 1, 2 and 3 specialised,
// powf otherwise), so the terms match the plain PyTorch version's.
#include "common.cuh"

#include <math.h>

namespace helmet {

constexpr int kLossThreads = 256;  // a power of two: the tree reduction
constexpr int kTilePixels = 1024;
constexpr float kLossEps = 1e-7f;  // ref ops/pallas/loss.py:47

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float spow(float x, float e) {
  if (e == 0.f) return 1.f;
  if (e == 1.f) return x;
  if (e == 2.f) return __fmul_rn(x, x);
  if (e == 3.f) return __fmul_rn(__fmul_rn(x, x), x);
  return powf(x, e);
}

// sign(d) with sign(0) = 0, the Pallas kernel's d|x|/dx (loss.py:50)
__device__ __forceinline__ float sign0(float d) {
  return (float)((0.f < d) - (d < 0.f));
}

struct LossArgs {
  const float* heat;
  const float* off;
  const float* wh;
  const float* mask;
  int S, B, HW, C;
  float alpha, beta;
  bool normalized;
};

template <typename T>
__global__ void loss_fwd_kernel(const T* __restrict__ out, LossArgs args,
                                float* __restrict__ part) {
  __shared__ float red[4][kLossThreads];
  const int t = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int C = args.C, K = C + 4, HW = args.HW;
  const T* slab = out + ((long long)b * args.S + s) * HW * K;
  const int p1 = min((t + 1) * kTilePixels, HW);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int px = t * kTilePixels + threadIdx.x; px < p1; px += blockDim.x) {
    const T* o = slab + (long long)px * K;
    const long long q = (long long)b * HW + px;
    const float m = args.mask[q];
    const float nm = __fsub_rn(1.f, m);
    const float* g = args.heat + q * C;
    for (int c = 0; c < C; ++c) {
      const float p = sigmoid(to_f32(o[c]));
      const float omp = __fsub_rn(1.f, p);
      // log(p + eps) * (1 - p)^alpha * m
      acc[0] = __fadd_rn(
          acc[0], __fmul_rn(__fmul_rn(logf(__fadd_rn(p, kLossEps)),
                                      spow(omp, args.alpha)),
                            m));
      // log(1 - p + eps) * p^alpha * (1 - g)^beta * (1 - m)
      acc[1] = __fadd_rn(
          acc[1],
          __fmul_rn(__fmul_rn(__fmul_rn(logf(__fadd_rn(omp, kLossEps)),
                                        spow(p, args.alpha)),
                              spow(__fsub_rn(1.f, g[c]), args.beta)),
                    nm));
    }
    for (int j = 0; j < 2; ++j) {
      float po = to_f32(o[C + j]), pw = to_f32(o[C + 2 + j]);
      if (args.normalized) {
        po = sigmoid(po);
        pw = sigmoid(pw);
      }
      acc[2] = __fadd_rn(acc[2], fabsf(__fsub_rn(
                                     __fmul_rn(po, m),
                                     __fmul_rn(args.off[2 * q + j], m))));
      acc[3] = __fadd_rn(acc[3], fabsf(__fsub_rn(
                                     __fmul_rn(pw, m),
                                     __fmul_rn(args.wh[2 * q + j], m))));
    }
  }
  const int tid = threadIdx.x;
  for (int k = 0; k < 4; ++k) red[k][tid] = acc[k];
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride /= 2) {
    if (tid < stride)
      for (int k = 0; k < 4; ++k)
        red[k][tid] = __fadd_rn(red[k][tid], red[k][tid + stride]);
    __syncthreads();
  }
  if (tid < 4) {
    const long long sb = (long long)s * args.B + b;
    part[((long long)tid * args.S * args.B + sb) * gridDim.x + t] =
        red[tid][0];
  }
}

template <typename T>
__global__ void loss_bwd_kernel(const T* __restrict__ out, LossArgs args,
                                const float* __restrict__ gpos,
                                const float* __restrict__ gneg,
                                const float* __restrict__ goff,
                                const float* __restrict__ gwh,
                                T* __restrict__ dout) {
  const int t = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int C = args.C, K = C + 4, HW = args.HW;
  const long long slab = ((long long)b * args.S + s) * HW * K;
  const int sb = s * args.B + b;
  const float gp = gpos[sb], gn = gneg[sb], go = goff[sb], gw = gwh[sb];
  const float a = args.alpha, a1 = __fsub_rn(args.alpha, 1.f);
  const int p1 = min((t + 1) * kTilePixels, HW);
  for (int px = t * kTilePixels + threadIdx.x; px < p1; px += blockDim.x) {
    const T* o = out + slab + (long long)px * K;
    T* d = dout + slab + (long long)px * K;
    const long long q = (long long)b * HW + px;
    const float m = args.mask[q];
    const float nm = __fsub_rn(1.f, m);
    const float* g = args.heat + q * C;
    for (int c = 0; c < C; ++c) {
      const float p = sigmoid(to_f32(o[c]));
      const float omp = __fsub_rn(1.f, p);
      const float lp = logf(__fadd_rn(p, kLossEps));
      const float lq = logf(__fadd_rn(omp, kLossEps));
      // d(pos)/dp = ((1-p)^a / (p+eps) - a (1-p)^(a-1) log(p+eps)) m
      const float dpos = __fmul_rn(
          __fsub_rn(__fdiv_rn(spow(omp, a), __fadd_rn(p, kLossEps)),
                    __fmul_rn(__fmul_rn(a, spow(omp, a1)), lp)),
          m);
      // d(neg)/dp = (-p^a / (1-p+eps) + a p^(a-1) log(1-p+eps))
      //             (1-g)^b (1-m)
      const float dneg = __fmul_rn(
          __fmul_rn(
              __fadd_rn(__fdiv_rn(-spow(p, a), __fadd_rn(omp, kLossEps)),
                        __fmul_rn(__fmul_rn(a, spow(p, a1)), lq)),
              spow(__fsub_rn(1.f, g[c]), args.beta)),
          nm);
      // (gp dpos + gn dneg) p (1-p): the sigmoid's chain
      d[c] = from_f32<T>(__fmul_rn(
          __fmul_rn(__fadd_rn(__fmul_rn(gp, dpos), __fmul_rn(gn, dneg)), p),
          omp));
    }
    for (int j = 0; j < 2; ++j) {
      float po = to_f32(o[C + j]), pw = to_f32(o[C + 2 + j]);
      if (args.normalized) {
        po = sigmoid(po);
        pw = sigmoid(pw);
      }
      float dof = __fmul_rn(
          __fmul_rn(go, sign0(__fsub_rn(__fmul_rn(po, m),
                                        __fmul_rn(args.off[2 * q + j], m)))),
          m);
      float dwh = __fmul_rn(
          __fmul_rn(gw, sign0(__fsub_rn(__fmul_rn(pw, m),
                                        __fmul_rn(args.wh[2 * q + j], m)))),
          m);
      if (args.normalized) {
        dof = __fmul_rn(__fmul_rn(dof, po), __fsub_rn(1.f, po));
        dwh = __fmul_rn(__fmul_rn(dwh, pw), __fsub_rn(1.f, pw));
      }
      d[C + j] = from_f32<T>(dof);
      d[C + 2 + j] = from_f32<T>(dwh);
    }
  }
}

inline bool loss_shape_ok(int B, int S, int HW, int C) {
  return B > 0 && B <= 65535 && S > 0 && S <= 65535 && HW > 0 && C > 0;
}

inline int loss_tiles(int HW) { return (HW + kTilePixels - 1) / kTilePixels; }

}  // namespace helmet

// out (B, S, H, W, C+4) f32 or bf16 (dtype code); heat (B, H, W, C), off
// and wh (B, H, W, 2), mask (B, H, W, 1), all f32; HW = H * W; part is
// (4, S, B, tiles) f32 with tiles = ceil(HW / 1024).
extern "C" int helmet_loss_fwd(const void* out, const void* heat,
                               const void* off, const void* wh,
                               const void* mask, void* part, int B, int S,
                               int HW, int C, int tiles, float alpha,
                               float beta, int normalized, int dtype,
                               void* stream) {
  if (!helmet::loss_shape_ok(B, S, HW, C) || tiles != helmet::loss_tiles(HW))
    return (int)cudaErrorInvalidValue;
  const helmet::LossArgs args{static_cast<const float*>(heat),
                              static_cast<const float*>(off),
                              static_cast<const float*>(wh),
                              static_cast<const float*>(mask),
                              S, B, HW, C, alpha, beta, normalized != 0};
  const dim3 grid(tiles, B, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == helmet::kF32)
    helmet::loss_fwd_kernel<float><<<grid, helmet::kLossThreads, 0, s>>>(
        static_cast<const float*>(out), args, p);
  else if (dtype == helmet::kBF16)
    helmet::loss_fwd_kernel<__nv_bfloat16>
        <<<grid, helmet::kLossThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(out), args, p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The forward's operands, the four (S, B) f32 cotangents, and dout shaped
// and typed as out.
extern "C" int helmet_loss_bwd(const void* out, const void* heat,
                               const void* off, const void* wh,
                               const void* mask, const void* gpos,
                               const void* gneg, const void* goff,
                               const void* gwh, void* dout, int B, int S,
                               int HW, int C, float alpha, float beta,
                               int normalized, int dtype, void* stream) {
  if (!helmet::loss_shape_ok(B, S, HW, C)) return (int)cudaErrorInvalidValue;
  const helmet::LossArgs args{static_cast<const float*>(heat),
                              static_cast<const float*>(off),
                              static_cast<const float*>(wh),
                              static_cast<const float*>(mask),
                              S, B, HW, C, alpha, beta, normalized != 0};
  const dim3 grid(helmet::loss_tiles(HW), B, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(gpos);
  const float* gn = static_cast<const float*>(gneg);
  const float* go = static_cast<const float*>(goff);
  const float* gw = static_cast<const float*>(gwh);
  if (dtype == helmet::kF32)
    helmet::loss_bwd_kernel<float><<<grid, helmet::kLossThreads, 0, s>>>(
        static_cast<const float*>(out), args, gp, gn, go, gw,
        static_cast<float*>(dout));
  else if (dtype == helmet::kBF16)
    helmet::loss_bwd_kernel<__nv_bfloat16>
        <<<grid, helmet::kLossThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(out), args, gp, gn, go, gw,
            static_cast<__nv_bfloat16*>(dout));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
