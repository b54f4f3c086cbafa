// The host half of the card's JPEG decode: the resample source box of each image, from its
// full decoded dimensions, by the geometry the host pipeline uses (crop_geometry.h).
//
// The card decodes every JPEG at full size (nvJPEG) and resamples the box on the device
// (ops/csrc/resample.cu); the boxes come from here so that the eval centre crop and the
// seeded RandomResizedCrop are the host pipeline's, draw for draw. Needs no libjpeg, so it
// builds on a machine that has none. C ABI only (consumed via ctypes from native/bindings.py).

#include <cstdint>

#include "crop_geometry.h"

extern "C" {

// dims [n, 2] (height, width) of each image; mode 0 = eval (resize shorter side + centre
// crop), 1 = train (RandomResizedCrop from seeds[i] with the scale / ratio bounds).
// boxes [n, 4] receives (x0, y0, x1, y1) in the image's pixel coordinates.
void mm_crop_boxes(const int32_t* dims, int n, int size, int mode, const uint64_t* seeds,
                   double s_lo, double s_hi, double r_lo, double r_hi, double* boxes) {
  for (int i = 0; i < n; ++i) {
    const int h = dims[2 * i], w = dims[2 * i + 1];
    double* b = boxes + 4 * i;
    if (mode == 1) {
      const mmt::CropRect c = mmt::sample_crop(w, h, seeds[i], s_lo, s_hi, r_lo, r_hi);
      b[0] = c.left;
      b[1] = c.top;
      b[2] = c.left + c.w;
      b[3] = c.top + c.h;
    } else {
      const mmt::Box e = mmt::eval_box(w, h, size);
      b[0] = e.x0;
      b[1] = e.y0;
      b[2] = e.x1;
      b[3] = e.y1;
    }
  }
}

}  // extern "C"
