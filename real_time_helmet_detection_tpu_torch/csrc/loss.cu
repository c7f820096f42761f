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
// the forward runs one block per 512-pixel tile of an (s, b) map, two
// pixels per thread (32 x 16 = 512 blocks at the flagship, one wave on
// 132 SMs). `out` stays in the model's (B, S, ...) layout: the (stack,
// sample) swap is in the indexing, as the Pallas index maps do it;
// neighbouring threads read neighbouring pixels.
//
// The backward (loss_bwd_vec_kernel, the main path) stages each 512-pixel
// tile through shared memory: the tile's runs of out, heat, off, wh and
// mask are contiguous, so cp.async brings them in 16-byte pieces, some 26
// KB a block in flight at once (a pixel's six channels at a 24-byte
// stride would cost a warp 24 sectors a load instruction); d(out) goes
// back over the staged out and leaves in 16-byte streaming stores. The
// grid is one wave of resident blocks, one tile each at the flagship: on
// the card this beat smaller tiles streamed through two stages (their
// copies overlap the arithmetic, but fewer bytes are in flight), and
// branching around the positive focal term and (1-g)^beta where they are
// exactly zero or one cost more than the logf, divide and powf it saved.
// loss_bwd_kernel, one pixel a thread with scalar accesses, takes the
// shapes the vector kernel cannot (HW % 4 != 0, misaligned storage), by
// a choice in Python.
//
// The forward folds its tiles inside the launch ("last block done"): each
// block sums its pixels in a fixed shuffle order and writes its four tile
// partials, fences, and takes a ticket from an unsigned counter of its
// map; the block that takes the last ticket sums the map's partials in a
// fixed order and writes the (4, S, B) result. atomicInc wraps the counter
// back to 0 at that ticket, so the wrapper's zeroed counter buffer stays
// zero across launches and CUDA-graph replays. A cluster folding through
// distributed shared memory was the alternative; it caps a map at one
// cluster, 8 blocks portably (16 at most), so 1024-2048 pixels per block
// and 128-256 blocks at the flagship, where the ticket lets any number of
// tiles spread over the whole card. No float atomics: the sums reproduce
// bit for bit from run to run. Math is f32 through the __f*_rn intrinsics
// in the Pallas kernels' order; the sigmoid is ATen's 1 / (1 + expf(-x))
// and x**e for a scalar exponent follows ATen's CUDA pow(Tensor, Scalar)
// (0, 1, 2 and 3 specialised, powf otherwise), so the terms match the
// plain PyTorch version's.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace helmet {

constexpr int kLossThreads = 256;  // a multiple of 32, at most 1024
constexpr int kTilePixels = 1024;  // the scalar backward's tile
constexpr int kBwdTilePixels = 512;  // the vector backward's tile
constexpr int kBwdThreads = 256;  // and its block
constexpr int kFwdPixels = 2;      // the forward's pixels per thread
constexpr int kFwdTilePixels = kLossThreads * kFwdPixels;
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

// The four sums of the block's threads into red[k][0], k < 4, in a fixed
// order: each warp folds its 32 lanes by shuffles, then warp 0 folds the
// warps' sums. blockDim.x == kLossThreads.
__device__ __forceinline__ void block_sum4(float (&acc)[4],
                                           float (*red)[kLossThreads / 32]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc[k] = __fadd_rn(acc[k], __shfl_down_sync(0xffffffffu, acc[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[k][warp] = acc[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = lane < kLossThreads / 32 ? red[k][lane] : 0.f;
#pragma unroll
      for (int off = kLossThreads / 64; off > 0; off /= 2)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      acc[k] = v;
    }
  }
}

// The four loss terms of pixel px of map (s, b), added to acc.
template <typename T>
__device__ __forceinline__ void pixel_terms(const T* __restrict__ out,
                                            const LossArgs& args, int b,
                                            int s, int px, float* acc) {
  const int C = args.C, K = C + 4, HW = args.HW;
  const T* o = out + (((long long)b * args.S + s) * HW + px) * K;
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

// kFwdPixels pixels per thread (px, px + 256, ...), one kFwdTilePixels
// tile per block; the block's four tile sums go to part (4, S*B, tiles).
// The block that takes the last ticket of its (s, b) map folds that map's
// tiles in tile order into sums (4, S, B): warp 0, lane i summing tiles
// i, i + 32, ..., then the lanes by shuffles. The ticket is atomicInc on
// an unsigned counter per map, which wraps back to 0 at the last ticket,
// so every launch leaves the counters at 0.
template <typename T>
__global__ void __launch_bounds__(kLossThreads)
    loss_fwd_kernel(const T* __restrict__ out, LossArgs args,
                    float* __restrict__ part, unsigned* __restrict__ tickets,
                    float* __restrict__ sums) {
  __shared__ float red[4][kLossThreads / 32];
  __shared__ bool last;
  const int t = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int tiles = gridDim.x;
  const long long sb = (long long)s * args.B + b;
  const long long maps = (long long)args.S * args.B;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < kFwdPixels; ++r) {
    const int px = t * kFwdTilePixels + r * kLossThreads + threadIdx.x;
    if (px < args.HW) pixel_terms(out, args, b, s, px, acc);
  }
  block_sum4(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) part[(k * maps + sb) * tiles + t] = acc[k];
    __threadfence();  // the partials are visible before the ticket
    last = atomicInc(&tickets[sb], (unsigned)(tiles - 1)) ==
           (unsigned)(tiles - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  __threadfence();
  const int lane = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = 0.f;
    for (int i = lane; i < tiles; i += 32)
      v = __fadd_rn(v, __ldcg(part + (k * maps + sb) * tiles + i));
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) sums[k * maps + sb] = v;
  }
}

// The four (S, B) cotangents of the sums (pos, neg, off, wh), each with
// its own element strides over s and b, so the wrapper never copies them.
struct LossCots {
  const float* g[4];
  int ss[4], sb[4];
};

// The cotangents of one (s, b) map.
struct MapCots {
  float gp, gn, go, gw;
};

__device__ __forceinline__ MapCots map_cots(const LossCots& k, int s, int b) {
  float g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) g[i] = k.g[i][s * k.ss[i] + b * k.sb[i]];
  return MapCots{g[0], g[1], g[2], g[3]};
}

// d(out) of one pixel: o -> d, K = C + 4 values each. o and d may be the
// same storage: each value is read before its own d is written and after
// every earlier one. g: the C heat targets; m: the mask; of, wt: the
// offset and size targets.
template <typename T>
__device__ __forceinline__ void pixel_bwd(const T* o, T* d, const float* g,
                                          float m, const float* of,
                                          const float* wt,
                                          const LossArgs& args,
                                          const MapCots& k) {
  const int C = args.C;
  const float nm = __fsub_rn(1.f, m);
  const float a = args.alpha, a1 = __fsub_rn(args.alpha, 1.f);
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
        __fmul_rn(__fadd_rn(__fdiv_rn(-spow(p, a), __fadd_rn(omp, kLossEps)),
                            __fmul_rn(__fmul_rn(a, spow(p, a1)), lq)),
                  spow(__fsub_rn(1.f, g[c]), args.beta)),
        nm);
    // (gp dpos + gn dneg) p (1-p): the sigmoid's chain
    d[c] = from_f32<T>(__fmul_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(k.gp, dpos), __fmul_rn(k.gn, dneg)), p),
        omp));
  }
  for (int j = 0; j < 2; ++j) {
    float po = to_f32(o[C + j]), pw = to_f32(o[C + 2 + j]);
    if (args.normalized) {
      po = sigmoid(po);
      pw = sigmoid(pw);
    }
    float dof = __fmul_rn(
        __fmul_rn(k.go,
                  sign0(__fsub_rn(__fmul_rn(po, m), __fmul_rn(of[j], m)))),
        m);
    float dwh = __fmul_rn(
        __fmul_rn(k.gw,
                  sign0(__fsub_rn(__fmul_rn(pw, m), __fmul_rn(wt[j], m)))),
        m);
    if (args.normalized) {
      dof = __fmul_rn(__fmul_rn(dof, po), __fsub_rn(1.f, po));
      dwh = __fmul_rn(__fmul_rn(dwh, pw), __fsub_rn(1.f, pw));
    }
    d[C + j] = from_f32<T>(dof);
    d[C + 2 + j] = from_f32<T>(dwh);
  }
}

// The scalar backward: one block per kTilePixels tile of an (s, b) map,
// a pixel a thread per step, each value loaded and stored on its own. For
// the shapes the vector kernel cannot take.
template <typename T>
__global__ void loss_bwd_kernel(const T* __restrict__ out, LossArgs args,
                                LossCots cots, T* __restrict__ dout) {
  const int t = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int C = args.C, K = C + 4, HW = args.HW;
  const long long slab = ((long long)b * args.S + s) * HW * K;
  const MapCots k = map_cots(cots, s, b);
  const int p1 = min((t + 1) * kTilePixels, HW);
  for (int px = t * kTilePixels + threadIdx.x; px < p1; px += blockDim.x) {
    const long long q = (long long)b * HW + px;
    pixel_bwd(out + slab + (long long)px * K, dout + slab + (long long)px * K,
              args.heat + q * C, args.mask[q], args.off + 2 * q,
              args.wh + 2 * q, args, k);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// n 16-byte vectors from global src to shared dst, spread over the block
__device__ __forceinline__ void stage16(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async16(static_cast<uint4*>(dst) + i,
               static_cast<const uint4*>(src) + i);
}

// Shared memory of one vector-backward block: the tile's out (and then
// its d(out)) in T, heat, off, wh and mask in f32.
template <typename T>
__host__ __device__ __forceinline__ int bwd_smem_bytes(int C) {
  return kBwdTilePixels * ((C + 4) * (int)sizeof(T) + (C + 5) * 4);
}

// The vector backward. A block takes one kBwdTilePixels tile of an (s, b)
// map at a time: the tile's runs of out, heat, off, wh and mask are
// contiguous, and cp.async copies each into shared memory in 16-byte
// pieces, all in flight at once; each thread then computes its pixels
// from shared memory and writes d(out) over the tile's out there, and the
// block stores it with 16-byte streaming stores. The grid is one wave of
// resident blocks, each walking tiles (one each at the flagship). Needs
// every run 16-byte aligned: HW % 4 == 0, HW * K * sizeof(T) % 16 == 0,
// and the six pointers.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    loss_bwd_vec_kernel(const T* __restrict__ out, LossArgs args,
                        LossCots cots, T* __restrict__ dout, int tiles) {
  extern __shared__ uint4 stage[];
  const int C = args.C, K = C + 4, HW = args.HW;
  T* so = reinterpret_cast<T*>(stage);
  float* sg = reinterpret_cast<float*>(so + kBwdTilePixels * K);
  float* sof = sg + kBwdTilePixels * C;
  float* swh = sof + 2 * kBwdTilePixels;
  float* sm = swh + 2 * kBwdTilePixels;
  const long long total = (long long)tiles * args.B * args.S;
  for (long long i = blockIdx.x; i < total; i += gridDim.x) {
    const int t = (int)(i % tiles);
    const long long map = i / tiles;  // b * S + s, out's slab order
    const int s = (int)(map % args.S), b = (int)(map / args.S);
    const int px0 = t * kBwdTilePixels;
    const int n = min(kBwdTilePixels, HW - px0);  // a multiple of 4
    const long long o0 = (map * HW + px0) * K;
    const long long q0 = (long long)b * HW + px0;
    const int nvec = n * K * (int)sizeof(T) / 16;  // out's 16-byte pieces
    stage16(so, out + o0, nvec);
    stage16(sg, args.heat + q0 * C, n * C / 4);
    stage16(sof, args.off + 2 * q0, n / 2);
    stage16(swh, args.wh + 2 * q0, n / 2);
    stage16(sm, args.mask + q0, n / 4);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const MapCots k = map_cots(cots, s, b);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      pixel_bwd(so + j * K, so + j * K, sg + j * C, sm[j], sof + 2 * j,
                swh + 2 * j, args, k);
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(dout + o0);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x)
      __stcs(dst + v, stage[v]);
    __syncthreads();  // the next tile's copies overwrite the stage
  }
}

template <typename T>
cudaError_t launch_bwd_vec(const void* out, const LossArgs& args,
                           const LossCots& cots, void* dout, int tiles,
                           cudaStream_t stream) {
  const auto kernel = loss_bwd_vec_kernel<T>;
  const int smem = bwd_smem_bytes<T>(args.C);
  if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t e = launch_setup(reinterpret_cast<const void*>(kernel),
                                     kBwdThreads, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const long long total = (long long)tiles * args.B * args.S;
  kernel<<<wave_grid(per_sm, total), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(out), args, cots, static_cast<T*>(dout), tiles);
  return cudaGetLastError();
}

inline bool loss_shape_ok(int B, int S, int HW, int C) {
  return B > 0 && B <= 65535 && S > 0 && S <= 65535 && HW > 0 && C > 0;
}

inline int loss_tiles(int HW) { return (HW + kTilePixels - 1) / kTilePixels; }
inline int loss_bwd_tiles(int HW) {
  return (HW + kBwdTilePixels - 1) / kBwdTilePixels;
}
inline int loss_fwd_tiles(int HW) {
  return (HW + kFwdTilePixels - 1) / kFwdTilePixels;
}

}  // namespace helmet

// out (B, S, H, W, C+4) f32 or bf16 (dtype code); heat (B, H, W, C), off
// and wh (B, H, W, 2), mask (B, H, W, 1), all f32; HW = H * W; tiles =
// ceil(HW / 512); part (4, S, B, tiles) f32 scratch; tickets (S * B)
// unsigned, all 0 (every launch leaves them at 0); sums (4, S, B) f32, the
// result.
extern "C" int helmet_loss_fwd(const void* out, const void* heat,
                               const void* off, const void* wh,
                               const void* mask, void* part, void* tickets,
                               void* sums, int B, int S, int HW, int C,
                               int tiles, float alpha, float beta,
                               int normalized, int dtype, void* stream) {
  if (!helmet::loss_shape_ok(B, S, HW, C) ||
      tiles != helmet::loss_fwd_tiles(HW))
    return (int)cudaErrorInvalidValue;
  const helmet::LossArgs args{static_cast<const float*>(heat),
                              static_cast<const float*>(off),
                              static_cast<const float*>(wh),
                              static_cast<const float*>(mask),
                              S, B, HW, C, alpha, beta, normalized != 0};
  const dim3 grid(tiles, B, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  float* r = static_cast<float*>(sums);
  if (dtype == helmet::kF32)
    helmet::loss_fwd_kernel<float><<<grid, helmet::kLossThreads, 0, s>>>(
        static_cast<const float*>(out), args, p, tk, r);
  else if (dtype == helmet::kBF16)
    helmet::loss_fwd_kernel<__nv_bfloat16>
        <<<grid, helmet::kLossThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(out), args, p, tk, r);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The four cotangent pointers and their (s, b) element strides,
// strides[2 i], strides[2 i + 1] for cotangent i (host memory).
static helmet::LossCots loss_cots(const void* gpos, const void* gneg,
                                  const void* goff, const void* gwh,
                                  const int* strides) {
  helmet::LossCots k{{static_cast<const float*>(gpos),
                      static_cast<const float*>(gneg),
                      static_cast<const float*>(goff),
                      static_cast<const float*>(gwh)}, {}, {}};
  for (int i = 0; i < 4; ++i) {
    k.ss[i] = strides[2 * i];
    k.sb[i] = strides[2 * i + 1];
  }
  return k;
}

// The forward's operands, the four (S, B) f32 cotangents with their
// strides (cot_strides: 8 ints, host memory), and dout shaped and typed as
// out. The scalar kernel: any HW, any alignment of the storage types.
extern "C" int helmet_loss_bwd(const void* out, const void* heat,
                               const void* off, const void* wh,
                               const void* mask, const void* gpos,
                               const void* gneg, const void* goff,
                               const void* gwh, const void* cot_strides,
                               void* dout, int B, int S, int HW, int C,
                               float alpha, float beta, int normalized,
                               int dtype, void* stream) {
  if (!helmet::loss_shape_ok(B, S, HW, C) || cot_strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const helmet::LossArgs args{static_cast<const float*>(heat),
                              static_cast<const float*>(off),
                              static_cast<const float*>(wh),
                              static_cast<const float*>(mask),
                              S, B, HW, C, alpha, beta, normalized != 0};
  const helmet::LossCots cots = loss_cots(
      gpos, gneg, goff, gwh, static_cast<const int*>(cot_strides));
  const dim3 grid(helmet::loss_tiles(HW), B, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    helmet::loss_bwd_kernel<float><<<grid, helmet::kLossThreads, 0, s>>>(
        static_cast<const float*>(out), args, cots,
        static_cast<float*>(dout));
  else if (dtype == helmet::kBF16)
    helmet::loss_bwd_kernel<__nv_bfloat16>
        <<<grid, helmet::kLossThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(out), args, cots,
            static_cast<__nv_bfloat16*>(dout));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// As helmet_loss_bwd, by the vector kernel: tiles = ceil(HW / 512); needs
// HW % 4 == 0, HW * (C + 4) * element size % 16 == 0 and out, heat, off,
// wh, mask and dout 16-byte aligned, and is refused otherwise.
extern "C" int helmet_loss_bwd_vec(const void* out, const void* heat,
                                   const void* off, const void* wh,
                                   const void* mask, const void* gpos,
                                   const void* gneg, const void* goff,
                                   const void* gwh, const void* cot_strides,
                                   void* dout, int B, int S, int HW, int C,
                                   int tiles, float alpha, float beta,
                                   int normalized, int dtype, void* stream) {
  const int elem = dtype == helmet::kF32 ? 4 : 2;
  if (!helmet::loss_shape_ok(B, S, HW, C) || cot_strides == nullptr ||
      (dtype != helmet::kF32 && dtype != helmet::kBF16) ||
      tiles != helmet::loss_bwd_tiles(HW) || HW % 4 != 0 ||
      (long long)HW * (C + 4) * elem % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(heat) |
       reinterpret_cast<uintptr_t>(off) | reinterpret_cast<uintptr_t>(wh) |
       reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(dout)) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  const helmet::LossArgs args{static_cast<const float*>(heat),
                              static_cast<const float*>(off),
                              static_cast<const float*>(wh),
                              static_cast<const float*>(mask),
                              S, B, HW, C, alpha, beta, normalized != 0};
  const helmet::LossCots cots = loss_cots(
      gpos, gneg, goff, gwh, static_cast<const int*>(cot_strides));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == helmet::kF32)
    return (int)helmet::launch_bwd_vec<float>(out, args, cots, dout, tiles,
                                              s);
  return (int)helmet::launch_bwd_vec<__nv_bfloat16>(out, args, cots, dout,
                                                    tiles, s);
}
