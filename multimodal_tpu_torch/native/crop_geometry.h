// Crop geometry of the input pipeline, shared by the host JPEG decode (jpeg_pipeline.cc) and
// the host half of the card's decode (crop_boxes.cc): the eval resize-shorter + centre-crop
// source box, and torchvision's RandomResizedCrop drawn from a per-sample seed.
//
// Both are pure functions of the image's dimensions (and the seed), so every decoder that
// resamples from the same box with the same weights lands on the same pixels.

#pragma once

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <random>

namespace mmt {

struct CropRect {
  int left = 0, top = 0, w = 0, h = 0;
};

struct Box {
  double x0, y0, x1, y1;
};

// Resize the shorter side to `size` (PIL rounding), then centre-crop size x size, folded into
// one resample source box: the crop's output grid is the source box offset by
// crop_origin * (in/out per axis). Mirrors data/preprocess.py:eval_transform.
inline Box eval_box(int W, int H, int size) {
  const double scale = static_cast<double>(size) / std::min(W, H);
  const int new_w = std::max<int>(std::lround(W * scale), size);
  const int new_h = std::max<int>(std::lround(H * scale), size);
  const int left = (new_w - size) / 2, top = (new_h - size) / 2;
  const double sx = static_cast<double>(W) / new_w;
  const double sy = static_cast<double>(H) / new_h;
  return {left * sx, top * sy, (left + size) * sx, (top + size) * sy};
}

// torchvision RandomResizedCrop(scale, ratio) sampling algorithm (reference
// transform.py:108-117; bounds from --aug-cfg, defaults scale=(0.9,1.0)
// ratio=(3/4,4/3)): 10 area/log-ratio attempts, center-crop fallback. Sampling is a
// pure function of the image dimensions + seed.
inline CropRect sample_crop(int W, int H, uint64_t seed, double s_lo, double s_hi,
                            double r_lo, double r_hi) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> u01(0.0, 1.0);
  const double area = static_cast<double>(W) * H;
  const double log_r0 = std::log(r_lo), log_r1 = std::log(r_hi);
  CropRect c;
  c.w = -1;
  for (int attempt = 0; attempt < 10; ++attempt) {
    const double target_area = area * (s_lo + (s_hi - s_lo) * u01(rng));
    const double aspect = std::exp(log_r0 + (log_r1 - log_r0) * u01(rng));
    const int w = static_cast<int>(std::lround(std::sqrt(target_area * aspect)));
    const int h = static_cast<int>(std::lround(std::sqrt(target_area / aspect)));
    if (w > 0 && w <= W && h > 0 && h <= H) {
      c.w = w;
      c.h = h;
      c.left = static_cast<int>(u01(rng) * (W - w + 1));
      c.top = static_cast<int>(u01(rng) * (H - h + 1));
      return c;
    }
  }
  // fallback: clamp aspect, central crop
  const double in_ratio = static_cast<double>(W) / H;
  if (in_ratio < r_lo) {
    c.w = W;
    c.h = static_cast<int>(std::lround(c.w / r_lo));
  } else if (in_ratio > r_hi) {
    c.h = H;
    c.w = static_cast<int>(std::lround(c.h * r_hi));
  } else {
    c.w = W;
    c.h = H;
  }
  c.left = (W - c.w) / 2;
  c.top = (H - c.h) / 2;
  return c;
}

}  // namespace mmt
