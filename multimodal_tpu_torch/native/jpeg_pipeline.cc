// Native input pipeline: batched JPEG decode + PIL-compatible bicubic resample + crop.
//
// TPU-native replacement for the reference's CPU dataloader-worker decode path
// (Datasets/preProcess.py:17-25 via PIL, AlignCLIP/main/data.py:487 via torchvision):
// the classic input-bound bottleneck for 224x224 contrastive training. Design:
//   * libjpeg DCT-domain downscaling (scale_denom 1/2/4/8) so large photos are never fully
//     decoded — pick the smallest scale that still exceeds the resample target;
//   * separable convolution resampling with PIL's bicubic kernel (a = -0.5) and PIL's
//     downscale filter widening (filterscale = in/out), so eval preprocessing matches the
//     reference's PIL pipeline to rounding;
//   * train mode = torchvision RandomResizedCrop(scale=(0.9,1.0), ratio=(3/4,4/3)) sampling
//     (same algorithm as reference transform.py:108-117), seeded per sample for determinism;
//   * output is uint8 RGB HWC — normalization runs on the device
//     (data/preprocess.py:normalize_images), quartering host->device traffic;
//   * per-sample failure absorption: a corrupt image yields a black frame + error flag
//     (the reference's semantics, Models/clipModel.py:169-178, main/data.py:276-279).
//
// The crop geometry (eval box, RandomResizedCrop) lives in crop_geometry.h, shared with the
// host half of the card's decode. C ABI only (consumed via ctypes from native/bindings.py).

#include <cstddef>  // jpeglib.h needs size_t/FILE declared first
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include "crop_geometry.h"

namespace {

using mmt::CropRect;
using mmt::sample_crop;

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, with DCT downscaling + robust error handling)
// ---------------------------------------------------------------------------

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

struct Image {
  std::vector<uint8_t> data;  // HWC RGB
  int w = 0, h = 0;
};

// Decode JPEG bytes to RGB. min_side_target: pick largest DCT denom keeping
// min(w,h) >= min_side_target. Returns false on any decode error.
bool decode_jpeg(const uint8_t* buf, size_t len, int min_side_target, Image* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }

  const int full_min = std::min<int>(cinfo.image_width, cinfo.image_height);
  int denom = 1;
  for (int d = 2; d <= 8; d *= 2) {
    if (full_min / d >= min_side_target) denom = d;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;

  bool cmyk = false;
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    cinfo.out_color_space = JCS_CMYK;  // libjpeg can't go CMYK->RGB; convert below
    cmyk = true;
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width, h = cinfo.output_height;
  const int nc = cinfo.output_components;
  if (w <= 0 || h <= 0 || (nc != 3 && nc != 4)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->w = w;
  out->h = h;
  out->data.resize(static_cast<size_t>(w) * h * 3);
  std::vector<uint8_t> row(static_cast<size_t>(w) * nc);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out->data.data() + static_cast<size_t>(y) * w * 3;
    if (!cmyk) {
      std::memcpy(dst, rowp, static_cast<size_t>(w) * 3);
    } else {
      // Adobe-style inverted CMYK (what JPEGs in the wild use): RGB = C*K/255 etc.
      for (int x = 0; x < w; ++x) {
        const int c = rowp[x * 4], m = rowp[x * 4 + 1], ye = rowp[x * 4 + 2],
                  k = rowp[x * 4 + 3];
        dst[x * 3 + 0] = static_cast<uint8_t>(c * k / 255);
        dst[x * 3 + 1] = static_cast<uint8_t>(m * k / 255);
        dst[x * 3 + 2] = static_cast<uint8_t>(ye * k / 255);
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PIL-compatible separable bicubic resampling with source box
// ---------------------------------------------------------------------------

inline double bicubic_filter(double x) {  // Keys kernel, a = -0.5 (PIL's BICUBIC)
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Contribs {
  std::vector<int> bounds;       // [out * 2]: (first, count)
  std::vector<float> weights;    // [out * kmax]; f32 exceeds PIL's 8.8 fixed-point
  int kmax = 0;
};

// Precompute 1-D contributions for resampling the [box0, box1) window of an in_size-wide
// axis to out_size. Taps clamp to the FULL image [0, in_size) — PIL's box-resize semantics:
// the box positions the output grid, it does not truncate the filter footprint. Weight
// NORMALIZATION stays in double (PIL computes coefficients in double before quantizing);
// storage is float: PIL itself stores them as 8.8-ish fixed-point INT16, so f32 is
// strictly more precise than the parity target.
Contribs compute_contribs(int out_size, double box0, double box1, int in_size) {
  Contribs c;
  const double in_span = box1 - box0;
  const double scale = in_span / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  c.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds.resize(out_size * 2);
  c.weights.assign(static_cast<size_t>(out_size) * c.kmax, 0.0f);
  std::vector<double> wtmp(c.kmax);
  for (int i = 0; i < out_size; ++i) {
    const double center = box0 + (i + 0.5) * scale;
    int first = static_cast<int>(center - support + 0.5);
    int last = static_cast<int>(center + support + 0.5);
    first = std::max(first, 0);
    last = std::min(last, in_size);
    double sum = 0.0;
    for (int j = first; j < last; ++j) {
      const double wv = bicubic_filter((j - center + 0.5) / filterscale);
      wtmp[j - first] = wv;
      sum += wv;
    }
    float* w = &c.weights[static_cast<size_t>(i) * c.kmax];
    if (sum != 0.0)
      for (int j = 0; j < last - first; ++j)
        w[j] = static_cast<float>(wtmp[j] / sum);
    c.bounds[i * 2] = first;
    c.bounds[i * 2 + 1] = last - first;
  }
  return c;
}

inline uint8_t clamp8(float v) {
  return static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v + 0.5f)));
}

// Resample src (HWC u8) region [bx0,bx1)x[by0,by1) to out_w x out_h (HWC u8).
// Hot path of the input pipeline (decode is DCT-downscaled; this runs at full tap count):
// f32 arithmetic (>= PIL's fixed-point precision), no in-loop clamps (compute_contribs
// already bounds every tap), and a row-accumulator vertical pass so both passes are
// sequential-access FMA loops the compiler auto-vectorizes. The f32 intermediates are
// thread-local arenas: the horizontal-pass buffer is ~1 MB per image, and per-image
// malloc/page-fault churn measured as a real cost at the 900 img/s/core rate.
void resample(const Image& src, double bx0, double by0, double bx1, double by1,
              int out_w, int out_h, uint8_t* dst) {
  const Contribs cx = compute_contribs(out_w, bx0, bx1, src.w);
  const Contribs cy = compute_contribs(out_h, by0, by1, src.h);
  // horizontal pass over exactly the rows the vertical pass will tap
  int y_lo = src.h, y_hi = 0;
  for (int y = 0; y < out_h; ++y) {
    y_lo = std::min(y_lo, cy.bounds[y * 2]);
    y_hi = std::max(y_hi, cy.bounds[y * 2] + cy.bounds[y * 2 + 1]);
  }
  y_lo = std::max(y_lo, 0);
  y_hi = std::min(y_hi, src.h);
  const int tmp_h = y_hi - y_lo;
  thread_local std::vector<float> tmp;
  tmp.resize(static_cast<size_t>(tmp_h) * out_w * 3);
  // Horizontal pass via a 4-channel (RGBX) f32 staging row — the Pillow-SIMD layout:
  // each tap becomes ONE contiguous 4-wide FMA (the interleaved-RGB stride-3 gather
  // defeated auto-vectorization; measured ~1.5x on this pass).
  thread_local std::vector<float> row4;
  row4.resize(static_cast<size_t>(src.w) * 4);
  for (int y = 0; y < tmp_h; ++y) {
    const uint8_t* srow = src.data.data() + static_cast<size_t>(y + y_lo) * src.w * 3;
    float* r4 = row4.data();
    for (int xx = 0; xx < src.w; ++xx) {
      r4[xx * 4 + 0] = srow[xx * 3 + 0];
      r4[xx * 4 + 1] = srow[xx * 3 + 1];
      r4[xx * 4 + 2] = srow[xx * 3 + 2];
      r4[xx * 4 + 3] = 0.0f;
    }
    float* trow = &tmp[static_cast<size_t>(y) * out_w * 3];
    for (int x = 0; x < out_w; ++x) {
      const int first = cx.bounds[x * 2], count = cx.bounds[x * 2 + 1];
      const float* w = &cx.weights[static_cast<size_t>(x) * cx.kmax];
      const float* p = r4 + static_cast<size_t>(first) * 4;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < count; ++j, p += 4) {
        const float wj = w[j];
        acc[0] += wj * p[0];
        acc[1] += wj * p[1];
        acc[2] += wj * p[2];
        acc[3] += wj * p[3];
      }
      trow[x * 3 + 0] = acc[0];
      trow[x * 3 + 1] = acc[1];
      trow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass: accumulate whole rows (sequential loads over tmp, one FMA sweep per
  // tap) instead of walking columns — the strided column walk was the cache bottleneck
  thread_local std::vector<float> acc;
  acc.resize(static_cast<size_t>(out_w) * 3);
  const size_t row_elems = static_cast<size_t>(out_w) * 3;
  for (int y = 0; y < out_h; ++y) {
    const int first = cy.bounds[y * 2], count = cy.bounds[y * 2 + 1];
    const float* w = &cy.weights[static_cast<size_t>(y) * cy.kmax];
    std::memset(acc.data(), 0, row_elems * sizeof(float));
    for (int j = 0; j < count; ++j) {
      const float wj = w[j];
      const float* p = &tmp[(static_cast<size_t>(first + j - y_lo)) * row_elems];
      float* a = acc.data();
      for (size_t x = 0; x < row_elems; ++x) a[x] += wj * p[x];
    }
    uint8_t* drow = dst + static_cast<size_t>(y) * row_elems;
    for (size_t x = 0; x < row_elems; ++x) drow[x] = clamp8(acc[x]);
  }
}

// ---------------------------------------------------------------------------
// Transforms: eval (resize shorter -> center crop), train (RandomResizedCrop)
// ---------------------------------------------------------------------------

void eval_transform(const Image& img, int size, uint8_t* out) {
  // Resize shorter side to `size` (PIL rounding), then center crop to size x size.
  // Mirrors data/preprocess.py:eval_transform (geometry in crop_geometry.h).
  const mmt::Box b = mmt::eval_box(img.w, img.h, size);
  resample(img, b.x0, b.y0, b.x1, b.y1, size, size, out);
}

void train_transform(const Image& img, int size, uint64_t seed, uint8_t* out,
                     double s_lo = 0.9, double s_hi = 1.0,
                     double r_lo = 3.0 / 4.0, double r_hi = 4.0 / 3.0) {
  const CropRect c = sample_crop(img.w, img.h, seed, s_lo, s_hi, r_lo, r_hi);
  resample(img, c.left, c.top, c.left + c.w, c.top + c.h, size, size, out);
}

// ---------------------------------------------------------------------------
// Fast train path: crop-folded fractional-DCT partial decode
// ---------------------------------------------------------------------------
//
// The full-decode train path pays for pixels it immediately throws away: the whole
// image is IDCT'd and color-converted, then ~95% of it is resampled down to size^2.
// libjpeg-turbo can do most of that reduction inside the decoder:
//   * fractional DCT scaling (scale M/8, M=1..8): the IDCT emits M x M pixels per
//     8 x 8 block — a high-quality DCT-domain low-pass + downsample in one step;
//   * jpeg_crop_scanline / jpeg_skip_scanlines: only the iMCU columns/rows covering
//     the crop are entropy-decoded + IDCT'd.
// The crop rect is sampled from the HEADER dimensions with the same seed/algorithm as
// the full path (identical RNG stream), the smallest M with min(crop)*M/8 >= size is
// chosen (so the final bicubic runs near 1:1), the decoded region is padded by the
// bicubic support so edge taps see real pixels, and the tail of the image is abandoned
// with jpeg_abort_decompress. Eval keeps the exact full-decode path (PIL bit-parity);
// train crops trade the full-decode's resample chain for the DCT low-pass — measured
// indistinguishable for training (tests/test_native_robustness.py fast-vs-slow gate).
// Returns false on any decode problem -> caller falls back to the exact path.
bool train_fast(const uint8_t* buf, size_t len, int size, uint64_t seed,
                double s_lo, double s_hi, double r_lo, double r_hi, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const int W = cinfo.image_width, H = cinfo.image_height;
  if (W <= 0 || H <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const CropRect c = sample_crop(W, H, seed, s_lo, s_hi, r_lo, r_hi);

  // smallest fractional scale that keeps the crop at/above the output size
  // (MMTPU_TRAIN_DECODE_HEADROOM > 1 decodes proportionally larger for extra fidelity)
  static const double headroom = [] {
    const char* e = std::getenv("MMTPU_TRAIN_DECODE_HEADROOM");
    double v = e ? std::atof(e) : 1.0;
    return (v >= 1.0 && v <= 8.0) ? v : 1.0;
  }();
  const int crop_min = std::min(c.w, c.h);
  int M = 8;
  if (crop_min > 0) {
    M = static_cast<int>(std::ceil(8.0 * size * headroom / crop_min));
    M = std::max(1, std::min(8, M));
  }
  cinfo.scale_num = M;
  cinfo.scale_denom = 8;
  // train-only decoder shortcuts (eval keeps libjpeg defaults for PIL parity): the
  // fast IDCT and plain (merged) chroma upsampling are visually minor next to the
  // random crop + bicubic that follow, and measurably cheaper
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;
  cinfo.do_block_smoothing = FALSE;
  bool cmyk = false;
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    cinfo.out_color_space = JCS_CMYK;
    cmyk = true;
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width, sh = cinfo.output_height;
  const int nc = cinfo.output_components;
  if (sw <= 0 || sh <= 0 || (nc != 3 && nc != 4)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // crop box in scaled coordinates (doubles — the resample box handles fractions)
  const double fx = static_cast<double>(sw) / W, fy = static_cast<double>(sh) / H;
  const double sx0 = c.left * fx, sx1 = (c.left + c.w) * fx;
  const double sy0 = c.top * fy, sy1 = (c.top + c.h) * fy;
  // pad by the bicubic support so edge taps land on real pixels (PIL semantics: the
  // box positions the grid, taps read the full image)
  const double fs_x = std::max((sx1 - sx0) / size, 1.0);
  const double fs_y = std::max((sy1 - sy0) / size, 1.0);
  const int pad_x = static_cast<int>(std::ceil(2.0 * fs_x)) + 1;
  const int pad_y = static_cast<int>(std::ceil(2.0 * fs_y)) + 1;
  // Partial decode only pays when it skips real work: with no DCT downscale (M=8) and
  // a near-full crop (the scale=(0.9,1.0) default!), crop_scanline/skip/abort overhead
  // measured a net LOSS on 256px sources — decode everything with the fast IDCT then.
  const double crop_frac = (static_cast<double>(c.w) * c.h) / (static_cast<double>(W) * H);
  const bool partial = (M < 8) || (crop_frac < 0.8);
  JDIMENSION xoff = 0;
  JDIMENSION xwidth = static_cast<JDIMENSION>(sw);
  int ry0 = 0, ry1 = sh, y0 = 0;
  if (partial) {
    xoff = static_cast<JDIMENSION>(
        std::max(0, static_cast<int>(std::floor(sx0)) - pad_x));
    int rx1 = std::min(sw, static_cast<int>(std::ceil(sx1)) + pad_x);
    xwidth = static_cast<JDIMENSION>(rx1 - static_cast<int>(xoff));
    jpeg_crop_scanline(&cinfo, &xoff, &xwidth);  // adjusts outward to iMCU columns
    ry0 = std::max(0, static_cast<int>(std::floor(sy0)) - pad_y);
    ry1 = std::min(sh, static_cast<int>(std::ceil(sy1)) + pad_y);
    if (ry0 > 0)
      y0 = static_cast<int>(jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(ry0)));
  }

  thread_local Image region;
  region.w = static_cast<int>(xwidth);
  region.h = ry1 - y0;
  if (region.w <= 0 || region.h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  region.data.resize(static_cast<size_t>(region.w) * region.h * 3);
  thread_local std::vector<uint8_t> row;
  row.resize(static_cast<size_t>(region.w) * nc);
  uint8_t* rowp = row.data();
  while (static_cast<int>(cinfo.output_scanline) < ry1) {
    const int y = static_cast<int>(cinfo.output_scanline) - y0;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    if (y < 0 || y >= region.h) continue;  // defensive: skip_scanlines undershoot
    uint8_t* dst = region.data.data() + static_cast<size_t>(y) * region.w * 3;
    if (!cmyk) {
      std::memcpy(dst, rowp, static_cast<size_t>(region.w) * 3);
    } else {
      for (int x = 0; x < region.w; ++x) {
        const int cc = rowp[x * 4], m = rowp[x * 4 + 1], ye = rowp[x * 4 + 2],
                  k = rowp[x * 4 + 3];
        dst[x * 3 + 0] = static_cast<uint8_t>(cc * k / 255);
        dst[x * 3 + 1] = static_cast<uint8_t>(m * k / 255);
        dst[x * 3 + 2] = static_cast<uint8_t>(ye * k / 255);
      }
    }
  }
  jpeg_abort_decompress(&cinfo);  // abandon the rows below the crop
  jpeg_destroy_decompress(&cinfo);
  resample(region, sx0 - xoff, sy0 - y0, sx1 - xoff, sy1 - y0, size, size, out);
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Decode a batch of encoded images into out[n, size, size, 3] uint8.
// offsets[i] .. offsets[i+1] delimit sample i inside `blob` (a single packed buffer —
// one memcpy-friendly ctypes crossing instead of n pointers).
// mode: 0 = eval (resize+center crop), 1 = train (RandomResizedCrop, seeded by seeds[i]).
// ok[i] = 1 decoded, 0 failed (out black-filled). Returns count of failures.
// _aug variant: RandomResizedCrop bounds from --aug-cfg (scale_lo/hi, ratio_lo/hi);
// mm_decode_batch below forwards with the reference defaults, so its RNG stream and
// output are bit-identical to the pre-aug ABI.
int mm_decode_batch_aug(const uint8_t* blob, const int64_t* offsets, int n, int size,
                        int mode, const uint64_t* seeds, uint8_t* out, uint8_t* ok,
                        int n_threads, double s_lo, double s_hi, double r_lo, double r_hi) {
  std::atomic<int> next(0), failures(0);
  // 2x headroom before DCT-domain downscaling: keeps the decode-at-1/k + bicubic result
  // within rounding of full-decode + bicubic (no aliasing drift vs the PIL reference).
  // MMTPU_DECODE_HEADROOM overrides (e.g. 1.3 trades a touch of resample fidelity for
  // engaging the 1/2 DCT scale on ~2x-target shards — measured speed/parity tradeoff).
  static const double headroom = [] {
    const char* e = std::getenv("MMTPU_DECODE_HEADROOM");
    double v = e ? std::atof(e) : 2.0;
    return (v >= 1.0 && v <= 8.0) ? v : 2.0;
  }();
  const int min_side = static_cast<int>(std::lround(size * headroom));
  // Fast train decode (crop-folded fractional-DCT partial decode) is the default for
  // mode=1; MMTPU_TRAIN_FAST_DECODE=0 restores the exact full-decode path (eval always
  // uses the exact path — it carries the PIL bit-parity contract).
  const char* fast_env = std::getenv("MMTPU_TRAIN_FAST_DECODE");
  const bool fast_train = !(fast_env && fast_env[0] == '0');  // per-call: testable
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* buf = blob + offsets[i];
      const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
      uint8_t* dst = out + static_cast<size_t>(i) * size * size * 3;
      const bool is_jpeg = len > 3 && buf[0] == 0xFF && buf[1] == 0xD8;
      if (mode == 1 && fast_train && is_jpeg &&
          train_fast(buf, len, size, seeds ? seeds[i] : 0, s_lo, s_hi, r_lo, r_hi,
                     dst)) {
        ok[i] = 1;
        continue;
      }
      thread_local Image img;
      bool good = is_jpeg && decode_jpeg(buf, len, min_side, &img) && img.w > 0 &&
                  img.h > 0;
      if (!good) {
        std::memset(dst, 0, static_cast<size_t>(size) * size * 3);
        ok[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      if (mode == 1) {
        train_transform(img, size, seeds ? seeds[i] : 0, dst, s_lo, s_hi, r_lo, r_hi);
      } else {
        eval_transform(img, size, dst);
      }
      ok[i] = 1;
    }
  };
  const int t = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

int mm_decode_batch(const uint8_t* blob, const int64_t* offsets, int n, int size, int mode,
                    const uint64_t* seeds, uint8_t* out, uint8_t* ok, int n_threads) {
  return mm_decode_batch_aug(blob, offsets, n, size, mode, seeds, out, ok, n_threads,
                             0.9, 1.0, 3.0 / 4.0, 4.0 / 3.0);
}

// Probe: is this buffer a JPEG we handle natively? (PNG/webp go to the Python fallback.)
int mm_is_jpeg(const uint8_t* buf, int64_t len) {
  return (len > 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF) ? 1 : 0;
}

}  // extern "C"
