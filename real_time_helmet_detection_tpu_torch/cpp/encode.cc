// Native host-side GT encoder: boxes -> (heatmap, offset, size, mask).
//
// The port's copy of the JAX package's host encoder (ref
// cpp/hostops/encode.cc:1-113), its arithmetic unchanged, so that the
// collate of the train input pipeline encodes its targets without the
// vectorized numpy broadcast. Semantics are those of the numpy encoder
// ops/encode.py `encode_boxes` (the reference's transform.py:4-70
// `box2hm`), bit for bit:
//
//   * center index = clip(floor(center / scale), 0, dim-1)
//   * offset = fractional center, size = scaled w/h; `normalized` divides
//     offsets by scale and sizes by map w/h
//   * in-order point scatter — the LAST box at a coincident center wins
//   * gaussian radius r = half-diagonal at map scale, sigma = max(r,1e-6)/3,
//     support window |dx|,|dy| <= floor(r) around the center INDEX,
//     same-class overlaps merge with max
//
// Complexity: O(sum of window areas) per image instead of the numpy
// broadcast's O(N * H * W).
//
// A plain C ABI bound with ctypes (data/encode_native.py); no Python or
// torch headers, so it builds with a bare `g++ -shared`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Arrays are channels-last C-order: heat (H, W, C), offset/size (H, W, 2),
// mask (H, W, 1). All must be zero-initialized by the caller.
void encode_boxes_f32(const float* boxes, const int32_t* labels, int32_t n,
                      int32_t width, int32_t height, float scale_factor,
                      int32_t num_cls, int32_t normalized, float* heat,
                      float* offset, float* size, float* mask) {
  for (int32_t i = 0; i < n; ++i) {
    const float xmin = boxes[i * 4 + 0] / scale_factor;
    const float ymin = boxes[i * 4 + 1] / scale_factor;
    const float xmax = boxes[i * 4 + 2] / scale_factor;
    const float ymax = boxes[i * 4 + 3] / scale_factor;
    const int32_t cls = labels[i];

    const float xcen = (xmin + xmax) * 0.5f;
    const float ycen = (ymin + ymax) * 0.5f;
    const int32_t xind = std::clamp(
        static_cast<int32_t>(std::floor(xcen)), 0, width - 1);
    const int32_t yind = std::clamp(
        static_cast<int32_t>(std::floor(ycen)), 0, height - 1);

    float xoff = xcen - static_cast<float>(xind);
    float yoff = ycen - static_cast<float>(yind);
    float xsize = xmax - xmin;
    float ysize = ymax - ymin;
    if (normalized) {
      xoff /= scale_factor;
      yoff /= scale_factor;
      xsize /= static_cast<float>(width);
      ysize /= static_cast<float>(height);
    }

    // point scatter (in order; last coincident box wins)
    const int64_t p = (static_cast<int64_t>(yind) * width + xind);
    offset[p * 2 + 0] = xoff;
    offset[p * 2 + 1] = yoff;
    size[p * 2 + 0] = xsize;
    size[p * 2 + 1] = ysize;
    mask[p] = 1.0f;

    // windowed gaussian splat, max-merged per class. An out-of-range label
    // skips only the splat — the numpy encoder likewise scatters the
    // offset/size/mask point for any label but draws heat only for
    // classes in [0, num_cls).
    if (cls < 0 || cls >= num_cls) continue;
    const float dxc = xcen - xmin, dyc = ycen - ymin;
    const float radius = std::sqrt(dxc * dxc + dyc * dyc);
    const int32_t ri = static_cast<int32_t>(std::floor(radius));
    const float sigma = std::max(radius, 1e-6f) / 3.0f;
    const float denom = 2.0f * sigma * sigma;
    const int32_t y0 = std::max(yind - ri, 0);
    const int32_t y1 = std::min(yind + ri, height - 1);
    const int32_t x0 = std::max(xind - ri, 0);
    const int32_t x1 = std::min(xind + ri, width - 1);
    for (int32_t y = y0; y <= y1; ++y) {
      const float dy = static_cast<float>(y - yind);
      for (int32_t x = x0; x <= x1; ++x) {
        const float dx = static_cast<float>(x - xind);
        const float g = std::exp(-(dx * dx + dy * dy) / denom);
        float* cell =
            &heat[(static_cast<int64_t>(y) * width + x) * num_cls + cls];
        *cell = std::max(*cell, g);
      }
    }
  }
}

// Batched variant: one call per collate (amortizes the ctypes overhead).
// boxes (B, max_boxes, 4), labels (B, max_boxes), counts (B).
void encode_boxes_batch_f32(const float* boxes, const int32_t* labels,
                            const int32_t* counts, int32_t batch,
                            int32_t max_boxes, int32_t width, int32_t height,
                            float scale_factor, int32_t num_cls,
                            int32_t normalized, float* heat, float* offset,
                            float* size, float* mask) {
  const int64_t hw = static_cast<int64_t>(height) * width;
  for (int32_t b = 0; b < batch; ++b) {
    encode_boxes_f32(boxes + static_cast<int64_t>(b) * max_boxes * 4,
                     labels + static_cast<int64_t>(b) * max_boxes, counts[b],
                     width, height, scale_factor, num_cls, normalized,
                     heat + b * hw * num_cls, offset + b * hw * 2,
                     size + b * hw * 2, mask + b * hw);
  }
}

}  // extern "C"
