// Fused sigmoid + (2p+1)^2 peak test on the raw detector output.
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/peak.py,
// `_peak_kernel` (reached through `fused_peak_scores`).
//
// For each (image, stack, class) map: s = sigmoid(logit); out = s where s
// equals the max of s over its (2p+1)^2 window (ties count; cells outside
// the map are -inf; a window that holds a NaN has a NaN max, so its cell
// is 0, as F.max_pool2d and jnp.maximum propagate NaN), else 0.
//
// Bound on the H100: bytes, and at the main path's size launch latency.
// It reads the C heat channels out of the (B, S, h, w, C+4) f32 logits and
// writes (B, S, C, h, w) f32: at (16, 1, 128, 128) with C = 2 that is 2.1
// MB in and 2.1 MB out, about 1.3 us at 3.35 TB/s. The heat pairs sit at a
// 24-byte stride, so every 32-byte sector of the logits holds one: the
// layout forces the whole 6.3 MB of logits through the memory system, 8.4
// MB with the output, about 2.5 us.
//
// Design: the kernel reads the heat channels straight out of the
// channels-last logits and writes the class-major layout the top-k
// flattening wants, so neither of the TPU path's two transposes exists.
// One block takes a 32 x 16 spatial tile of one image and every class of
// it. It stages the tile plus a p-cell halo of sigmoids in shared memory:
// at C = 2 each cell's two heat logits come in one 8-byte load (the vector
// variant), else one class at a time by 4-byte loads (the scalar variant).
// The window max is separable, as the TPU kernel builds it: a horizontal
// (2p+1) max of each staged row into a row buffer, then a vertical (2p+1)
// max of that, four adjacent outputs per thread, read as 16-byte vectors
// from shared memory and (vector variant) written with one 16-byte
// streaming store. The max is PTX max.NaN, which propagates NaN. The grid
// is at most one wave of resident blocks, each walking tiles. sigmoid is
// 1 / (1 + expf(-x)), the formula ATen's CUDA sigmoid uses, built without
// --use_fast_math, so the output equals the plain PyTorch version bit for
// bit.
#include <stdint.h>

#include "common.cuh"

namespace helmet {

constexpr int kPeakTileW = 32;  // outputs per tile row, a multiple of 4
constexpr int kPeakTileH = 16;
constexpr int kPeakThreads = 256;
constexpr int kPeakMaxP = 40;  // pool size 81, ops/peak.py MAX_POOL_SIZE

// max(a, b), NaN when either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float peak_sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// Shared layout of one class plane: R = kPeakTileH + 2p staged rows of
// stride row_stride(p), tile column 0 at column lead(p) (a multiple of 4,
// so the tile's cells are 16-byte aligned), then R horizontal-max rows of
// kPeakTileW.
__host__ __device__ __forceinline__ int peak_lead(int p) {
  return (p + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int peak_row_stride(int p) {
  return (peak_lead(p) + kPeakTileW + p + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int peak_plane_floats(int p) {
  return (kPeakTileH + 2 * p) * (peak_row_stride(p) + kPeakTileW);
}

// VEC: C == 2, both classes in one pass (two planes), 8-byte loads and
// 16-byte stores; else one class a pass, 4-byte loads and stores.
template <bool VEC>
__global__ void __launch_bounds__(kPeakThreads)
    peak_kernel(const float* __restrict__ logits, float* __restrict__ out,
                int images, int C, int h, int w, int K, int p) {
  constexpr int P = VEC ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R = kPeakTileH + 2 * p;
  const int ss = peak_row_stride(p);
  const int lead = peak_lead(p);
  const int plane = peak_plane_floats(p);
  const int cells_w = kPeakTileW + 2 * p;  // staged cells per row
  const int tiles_x = (w + kPeakTileW - 1) / kPeakTileW;
  const int tiles_y = (h + kPeakTileH - 1) / kPeakTileH;
  const long long tiles = (long long)images * tiles_y * tiles_x;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_x);
    const long long rest = tile / tiles_x;
    const int ty = (int)(rest % tiles_y);
    const long long image = rest / tiles_y;  // b * S + s
    const int x0 = tx * kPeakTileW, y0 = ty * kPeakTileH;
    const float* src = logits + image * h * w * K;
    for (int c0 = 0; c0 < C; c0 += P) {
      // 1. sigmoids of the tile and its halo (-inf outside the map)
      for (int i = threadIdx.x; i < R * cells_w; i += kPeakThreads) {
        const int r = i / cells_w, j = i - r * cells_w;
        const int y = y0 - p + r, x = x0 - p + j;
        const bool in = y >= 0 && y < h && x >= 0 && x < w;
        float* cell = smem + r * ss + lead - p + j;
        const float* at = src + ((long long)y * w + x) * K + c0;
        if (VEC) {
          float2 v = make_float2(-INFINITY, -INFINITY);
          if (in) {
            v = __ldg(reinterpret_cast<const float2*>(at));
            v.x = peak_sigmoid(v.x);
            v.y = peak_sigmoid(v.y);
          }
          cell[0] = v.x;
          cell[plane] = v.y;
        } else {
          cell[0] = in ? peak_sigmoid(__ldg(at)) : -INFINITY;
        }
      }
      __syncthreads();
      // 2. horizontal (2p+1) max of every staged row
      for (int i = threadIdx.x; i < P * R * kPeakTileW; i += kPeakThreads) {
        const int q = i / (R * kPeakTileW), k = i - q * (R * kPeakTileW);
        const int r = k / kPeakTileW, x = k % kPeakTileW;
        const float* row = smem + q * plane + r * ss + lead - p + x;
        float m = row[0];
        for (int dx = 1; dx <= 2 * p; ++dx) m = max_nan(m, row[dx]);
        smem[q * plane + R * ss + r * kPeakTileW + x] = m;
      }
      __syncthreads();
      // 3. vertical (2p+1) max, the equality test, four outputs a thread
      constexpr int kQuads = kPeakTileH * kPeakTileW / 4;
      for (int i = threadIdx.x; i < P * kQuads; i += kPeakThreads) {
        const int q = i / kQuads, k = i - q * kQuads;
        const int r = k / (kPeakTileW / 4), x = k % (kPeakTileW / 4) * 4;
        const int y = y0 + r;
        if (y >= h || x0 + x >= w) continue;
        const float* hm = smem + q * plane + R * ss + r * kPeakTileW + x;
        float4 m = *reinterpret_cast<const float4*>(hm);
        for (int dy = 1; dy <= 2 * p; ++dy) {
          const float4 v =
              *reinterpret_cast<const float4*>(hm + dy * kPeakTileW);
          m.x = max_nan(m.x, v.x);
          m.y = max_nan(m.y, v.y);
          m.z = max_nan(m.z, v.z);
          m.w = max_nan(m.w, v.w);
        }
        const float4 s = *reinterpret_cast<const float4*>(
            smem + q * plane + (r + p) * ss + lead + x);
        const float4 o = make_float4(m.x == s.x ? s.x : 0.f,
                                     m.y == s.y ? s.y : 0.f,
                                     m.z == s.z ? s.z : 0.f,
                                     m.w == s.w ? s.w : 0.f);
        float* dst = out + ((image * C + c0 + q) * h + y) * (long long)w +
                     x0 + x;
        if (VEC) {
          __stcs(reinterpret_cast<float4*>(dst), o);
        } else {
          const float ov[4] = {o.x, o.y, o.z, o.w};
          for (int l = 0; l < 4 && x0 + x + l < w; ++l) dst[l] = ov[l];
        }
      }
      __syncthreads();  // the next pass overwrites the planes
    }
  }
}

template <bool VEC>
cudaError_t launch_peak(const float* logits, float* out, int images, int C,
                        int h, int w, int K, int p, cudaStream_t stream) {
  const auto kernel = peak_kernel<VEC>;
  const int smem = (VEC ? 2 : 1) * peak_plane_floats(p) * (int)sizeof(float);
  if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t e = launch_setup(reinterpret_cast<const void*>(kernel),
                                     kPeakThreads, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)images *
                          ((h + kPeakTileH - 1) / kPeakTileH) *
                          ((w + kPeakTileW - 1) / kPeakTileW);
  kernel<<<wave_grid(per_sm, tiles), kPeakThreads, smem, stream>>>(
      logits, out, images, C, h, w, K, p);
  return cudaGetLastError();
}

}  // namespace helmet

// The variant a launch takes, decided here for every caller (the Python
// op and the C++ op library alike): 1 (vector) when C == 2, K even, w % 4
// == 0, logits 8-byte and out 16-byte aligned, else 0 (scalar).
extern "C" int helmet_peak_pick(const void* logits, const void* out, int C,
                                int K, int w) {
  return C == 2 && K % 2 == 0 && w % 4 == 0 &&
         reinterpret_cast<uintptr_t>(logits) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// logits (images, h, w, K) f32 contiguous, the C heat channels first; out
// (images, C, h, w) f32; p = (pool_size - 1) / 2; tiles = images x
// ceil(h / 16) x ceil(w / 32). vec != 0 takes the vector variant, which
// needs C == 2, K even, w % 4 == 0, logits 8-byte and out 16-byte aligned,
// and is refused otherwise.
extern "C" int helmet_peak_scores(const void* logits, void* out, int images,
                                  int C, int h, int w, int K, int p,
                                  long long tiles, int vec, void* stream) {
  using namespace helmet;
  if (images <= 0 || C <= 0 || h <= 0 || w <= 0 || K < C || p < 0 ||
      p > kPeakMaxP ||
      tiles != (long long)images * ((h + kPeakTileH - 1) / kPeakTileH) *
                   ((w + kPeakTileW - 1) / kPeakTileW))
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(logits);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!vec) return (int)launch_peak<false>(x, o, images, C, h, w, K, p, s);
  if (C != 2 || K % 2 != 0 || w % 4 != 0 ||
      reinterpret_cast<uintptr_t>(logits) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_peak<true>(x, o, images, C, h, w, K, p, s);
}
