// The card's JPEG decode: nvJPEG decodes each image at full size into a device arena, then a
// hand-written resample pass (sm_90a) does the host pipeline's bicubic resample and crop on the
// device.
//
// The device form of native/jpeg_pipeline.cc's resample() (:200) and its eval / train
// transforms (not of a TPU kernel: the reference decodes on the host). Each output pixel is
// the separable sum the host computes: PIL's bicubic (a = -0.5) with the downscale widening
// (filterscale = in/out), taps clamped to the full image and weights renormalised, over the
// source box that native/crop_geometry.h gives (eval: resize shorter + centre crop; train:
// RandomResizedCrop from the sample's seed, full-image coordinates). The weights and tap
// bounds are computed on the host (ops/resample.py:contribs), so the plain PyTorch version
// runs the same weights; the passes accumulate in float32 and round as the host does
// (min(255, max(0, v + 0.5)), truncated).
//
//   resample_rows_kernel  src rows [y_lo, y_lo + rows) of each image -> tmp [rows, S, 3] f32
//                         (horizontal pass: one block per image and 4 rows, one thread per
//                         output element, taps walked in order)
//   resample_cols_kernel  tmp -> out [S, S, 3] uint8 (vertical pass: one block per image and
//                         output row; consecutive threads read consecutive tmp elements)
//
// Both are bound by bytes at the shapes of the input path (4-9 taps a pass when upsampling,
// up to ~70 when a 1100-px photo goes to 64 px). What the design does: the batch is one pair
// of launches whatever its images' sizes (per-image descriptors), the horizontal pass touches
// only the rows the vertical pass reads, and a failed image is written black. A decode that
// skips nvJPEG's full-size output (ROI decode, or the DCT-domain downscale the host uses) is
// later work.
//
// The nvJPEG half: mmt_jpeg_dims reads each header (nvjpegGetImageInfo, on the host);
// mmt_jpeg_decode decodes the images on n host threads, each with its own decoder state and
// non-blocking stream taken from a pool, after the caller's stream has reached the point where
// the arena was allocated, and returns once every image is written. A header or decode that
// nvJPEG refuses clears the image's ok flag (the caller routes it to the PIL path).

#include <atomic>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;
constexpr int kDesc = 12;  // int64 fields of an image's descriptor, see ops/resample.py
// descriptor fields
constexpr int kSrcOff = 0, kW = 2, kTmpOff = 3, kYLo = 4, kRows = 5, kWxOff = 6, kKx = 7,
              kWyOff = 8, kKy = 9, kOk = 10;

__global__ void __launch_bounds__(kThreads)
    resample_rows_kernel(const uint8_t* __restrict__ src, const int64_t* __restrict__ desc,
                         const float* __restrict__ wx, const int* __restrict__ bx,
                         float* __restrict__ tmp, int size) {
  const int64_t* d = desc + static_cast<size_t>(blockIdx.x) * kDesc;
  if (!d[kOk]) return;
  const int rows = static_cast<int>(d[kRows]);
  const int w = static_cast<int>(d[kW]);
  const int kx = static_cast<int>(d[kKx]);
  const int s3 = size * 3;
  const int* bounds = bx + static_cast<size_t>(blockIdx.x) * size * 2;
  const float* weights = wx + d[kWxOff];
  for (int rr = 0; rr < kRowsPerBlock; ++rr) {
    const int r = blockIdx.y * kRowsPerBlock + rr;
    if (r >= rows) return;
    const uint8_t* srow = src + d[kSrcOff] + static_cast<size_t>(d[kYLo] + r) * w * 3;
    float* trow = tmp + d[kTmpOff] + static_cast<size_t>(r) * s3;
    for (int e = threadIdx.x; e < s3; e += kThreads) {
      const int x = e / 3, c = e - 3 * x;
      const int first = bounds[2 * x], count = bounds[2 * x + 1];
      const float* wv = weights + static_cast<size_t>(x) * kx;
      const uint8_t* p = srow + static_cast<size_t>(first) * 3 + c;
      float acc = 0.0f;
      for (int j = 0; j < count; ++j) acc += wv[j] * static_cast<float>(p[3 * j]);
      trow[e] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    resample_cols_kernel(const int64_t* __restrict__ desc, const float* __restrict__ wy,
                         const int* __restrict__ by, const float* __restrict__ tmp,
                         uint8_t* __restrict__ out, int size) {
  const int64_t* d = desc + static_cast<size_t>(blockIdx.x) * kDesc;
  const int y = blockIdx.y;
  const int s3 = size * 3;
  uint8_t* orow = out + (static_cast<size_t>(blockIdx.x) * size + y) * s3;
  if (!d[kOk]) {
    for (int e = threadIdx.x; e < s3; e += kThreads) orow[e] = 0;
    return;
  }
  const int* bounds = by + (static_cast<size_t>(blockIdx.x) * size + y) * 2;
  const int first = bounds[0], count = bounds[1];
  const float* wv = wy + d[kWyOff] + static_cast<size_t>(y) * d[kKy];
  const float* base = tmp + d[kTmpOff] + static_cast<size_t>(first - d[kYLo]) * s3;
  for (int e = threadIdx.x; e < s3; e += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < count; ++j) acc += wv[j] * base[static_cast<size_t>(j) * s3 + e];
    orow[e] = static_cast<uint8_t>(fminf(255.0f, fmaxf(0.0f, acc + 0.5f)));
  }
}

// ------------------------------------------------------------------------------- nvJPEG
constexpr int kNvjpegError = 100000;  // + nvjpegStatus_t, to tell it from a cudaError_t

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;

struct Slot {
  nvjpegJpegState_t state;
  cudaStream_t stream;
  int device;
};
std::vector<Slot> g_pool;  // idle decoder states, reused across calls

int ensure_handle() {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_handle == nullptr) {
    const nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return kNvjpegError + static_cast<int>(st);
    }
  }
  return 0;
}

int acquire(int device, Slot* slot) {
  {
    std::lock_guard<std::mutex> lock(g_mu);
    for (size_t i = 0; i < g_pool.size(); ++i) {
      if (g_pool[i].device == device) {
        *slot = g_pool[i];
        g_pool.erase(g_pool.begin() + i);
        return 0;
      }
    }
  }
  slot->device = device;
  const nvjpegStatus_t st = nvjpegJpegStateCreate(g_handle, &slot->state);
  if (st != NVJPEG_STATUS_SUCCESS) return kNvjpegError + static_cast<int>(st);
  const cudaError_t err = cudaStreamCreateWithFlags(&slot->stream, cudaStreamNonBlocking);
  if (err != cudaSuccess) {
    nvjpegJpegStateDestroy(slot->state);
    return static_cast<int>(err);
  }
  return 0;
}

void release(const Slot& slot) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_pool.push_back(slot);
}

}  // namespace

extern "C" {

// src: the arena of decoded images; desc [n, 12] int64 (source offset, height, width, tmp
// offset, first tapped row, tapped rows, x-weight offset, x taps, y-weight offset, y taps, ok,
// unused); wx / wy float32 weights [size, taps] per image at their offsets; bx / by int32
// [n, size, 2] (first tap, tap count); tmp float32 scratch; out [n, size, size, 3] uint8.
// max_rows: the largest tapped-row count. Launches on `stream` without synchronising.
int mmt_resample(const void* src, const void* desc, const void* wx, const void* bx,
                 const void* wy, const void* by, void* tmp, void* out, int n, int size,
                 int max_rows, void* stream) {
  if (n < 1 || size < 1 || max_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (max_rows > 0) {
    const dim3 rows_grid(n, (max_rows + kRowsPerBlock - 1) / kRowsPerBlock);
    resample_rows_kernel<<<rows_grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(src), static_cast<const int64_t*>(desc),
        static_cast<const float*>(wx), static_cast<const int*>(bx), static_cast<float*>(tmp),
        size);
  }
  resample_cols_kernel<<<dim3(n, size), kThreads, 0, st>>>(
      static_cast<const int64_t*>(desc), static_cast<const float*>(wy),
      static_cast<const int*>(by), static_cast<const float*>(tmp), static_cast<uint8_t*>(out),
      size);
  return static_cast<int>(cudaGetLastError());
}

// The header of each JPEG: dims [n, 2] (height, width); ok[i] = 0 where nvJPEG refuses it.
// Returns 0, or kNvjpegError + status if no nvJPEG handle could be created.
int mmt_jpeg_dims(const uint8_t* blob, const int64_t* offsets, int n, int32_t* dims,
                  uint8_t* ok) {
  if (const int err = ensure_handle()) return err;
  for (int i = 0; i < n; ++i) {
    int comps = 0;
    nvjpegChromaSubsampling_t subsampling;
    int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
    const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    const nvjpegStatus_t st = nvjpegGetImageInfo(g_handle, blob + offsets[i], len, &comps,
                                                 &subsampling, widths, heights);
    const bool good = st == NVJPEG_STATUS_SUCCESS && widths[0] > 0 && heights[0] > 0;
    ok[i] = good ? 1 : 0;
    dims[2 * i] = good ? heights[0] : 0;
    dims[2 * i + 1] = good ? widths[0] : 0;
  }
  return 0;
}

// Decode image i (where ok[i]) as interleaved RGB into arena + arena_off[i], pitch width * 3,
// on n_threads host threads of the given device. The decodes start after `after`'s work queued
// so far (the arena's allocation point). Returns when every image is written (0), or the
// first CUDA error; a decode nvJPEG refuses clears ok[i].
int mmt_jpeg_decode(const uint8_t* blob, const int64_t* offsets, int n, uint8_t* arena,
                    const int64_t* arena_off, const int32_t* dims, uint8_t* ok, int n_threads,
                    int device, void* after) {
  if (const int err = ensure_handle()) return err;
  cudaError_t cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cudaEvent_t ready;
  cerr = cudaEventCreateWithFlags(&ready, cudaEventDisableTiming);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaEventRecord(ready, static_cast<cudaStream_t>(after));
  if (cerr != cudaSuccess) {
    cudaEventDestroy(ready);
    return static_cast<int>(cerr);
  }
  std::atomic<int> next(0), first_error(0);
  auto fail = [&](int err) {
    int none = 0;
    first_error.compare_exchange_strong(none, err);
  };
  auto worker = [&]() {
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return fail(static_cast<int>(set));
    Slot slot;
    if (const int err = acquire(device, &slot)) return fail(err);
    cudaStreamWaitEvent(slot.stream, ready, 0);
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      if (!ok[i]) continue;
      nvjpegImage_t img = {};
      img.channel[0] = arena + arena_off[i];
      img.pitch[0] = static_cast<size_t>(dims[2 * i + 1]) * 3;
      const nvjpegStatus_t st =
          nvjpegDecode(g_handle, slot.state, blob + offsets[i],
                       static_cast<size_t>(offsets[i + 1] - offsets[i]), NVJPEG_OUTPUT_RGBI,
                       &img, slot.stream);
      if (st != NVJPEG_STATUS_SUCCESS) ok[i] = 0;
    }
    const cudaError_t err = cudaStreamSynchronize(slot.stream);
    if (err != cudaSuccess) fail(static_cast<int>(err));
    release(slot);
  };
  const int t = n_threads < 1 ? 1 : (n_threads < n ? n_threads : (n > 0 ? n : 1));
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int k = 0; k < t; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  cudaEventDestroy(ready);
  return first_error.load();
}

}  // extern "C"
