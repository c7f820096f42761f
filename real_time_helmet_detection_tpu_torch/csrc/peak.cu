// Fused sigmoid + (2p+1)^2 peak test on the raw detector output.
//
// Replaces: real_time_helmet_detection_tpu/ops/pallas/peak.py,
// `_peak_kernel` (reached through `fused_peak_scores`).
//
// For each (image, stack, class) map: s = sigmoid(logit); out = s where s
// equals the max of s over its (2p+1)^2 window (ties count; cells outside
// the map are -inf), else 0.
//
// Bound on the H100: bytes, and at the main path's size really launch
// overhead. It reads the C heat channels out of the (B, S, h, w, C+4) f32
// logits and writes (B, S, C, h, w) f32: at (16, 1, 128, 128) with C = 2
// that is 2.1 MB in and 2.1 MB out, about 1.3 us at 3.35 TB/s.
//
// Design: the kernel reads the heat channels straight out of the
// channels-last logits (stride C+4) and writes the class-major layout the
// top-k flattening wants, so neither of the TPU path's two transposes
// exists. One block covers a 32 x 8 tile of one map and stages the tile
// plus a p-cell halo of sigmoids in shared memory (each sigmoid computed
// once per block), then each thread takes the max of its window from
// shared memory. sigmoid is 1 / (1 + expf(-x)), the formula ATen's CUDA
// sigmoid uses, built without --use_fast_math, so the output equals the
// plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void peak_kernel(const float* __restrict__ logits,
                            float* __restrict__ out, int C, int h, int w,
                            int K, int p) {
  extern __shared__ float tile[];  // (kTileY + 2p) rows x (kTileX + 2p)
  const int map = blockIdx.z;      // ((b * S) + s) * C + c
  const int c = map % C;
  const long long image = map / C;  // b * S + s
  const float* src = logits + image * (long long)h * w * K + c;
  float* dst = out + (long long)map * h * w;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tw = kTileX + 2 * p;
  const int th = kTileY + 2 * p;
  for (int i = threadIdx.y * kTileX + threadIdx.x; i < tw * th;
       i += kTileX * kTileY) {
    const int y = y0 + i / tw - p;
    const int x = x0 + i % tw - p;
    float s = -INFINITY;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float v = src[((long long)y * w + x) * K];
      s = 1.f / (1.f + expf(-v));
    }
    tile[i] = s;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const float s = tile[(threadIdx.y + p) * tw + threadIdx.x + p];
  float m = -INFINITY;
  for (int dy = 0; dy <= 2 * p; ++dy) {
    const float* row = tile + (threadIdx.y + dy) * tw + threadIdx.x;
    for (int dx = 0; dx <= 2 * p; ++dx) m = fmaxf(m, row[dx]);
  }
  dst[(long long)y * w + x] = (m == s) ? s : 0.f;
}

}  // namespace

extern "C" int helmet_peak_scores(const void* logits, void* out, int maps,
                                  int C, int h, int w, int K, int p,
                                  void* stream) {
  if (maps <= 0 || maps > 65535 || C <= 0 || h <= 0 || w <= 0 || K < C ||
      p < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kTileX + 2 * p) * (kTileY + 2 * p) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 block(kTileX, kTileY);
  dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, maps);
  peak_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(out), C, h, w, K,
      p);
  return (int)cudaGetLastError();
}
