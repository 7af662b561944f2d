// JPEG decode on the card through nvJPEG, behind a plain C interface.
//
// Counterpart of the libjpeg decode that the JAX package reaches through
// OpenCV (vision_kit_tpu/serve.py:decode_request_bytes, cv2.imdecode). It is
// a library call there and a library call here: no Pallas kernel stands
// behind it, so nothing is hand-written. The wrapper is
// data/decode.py:decode_jpeg_cuda, which reads the header on the host and
// hands nvJPEG only baseline, extended and complete progressive JPEGs in
// YCbCr or grey (decode_route; the rest decode on the host), then orients
// and letterboxes the output on the card.
//
// nvJPEG's simple API with its default backend: a handle per process (thread
// safe) and a decode state per concurrent caller (not thread safe; the
// wrapper keeps a pool). The output is interleaved RGB (NVJPEG_OUTPUT_RGBI)
// into a caller-given device buffer of pitch 3 W, or a grey JPEG's luma
// plane, on the caller's stream.
// Every pointer, size and stream crosses as a 64-bit value.

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

// a CUDA error after a call is reported as 1000 + its code, beside nvJPEG's
// own status codes (1..9)
int cuda_status() {
  cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err);
}

}  // namespace

extern "C" {

int vk_jpeg_version(int* major, int* minor, int* patch) {
  nvjpegStatus_t st = nvjpegGetProperty(MAJOR_VERSION, major);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegGetProperty(MINOR_VERSION, minor);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegGetProperty(PATCH_LEVEL, patch);
  return static_cast<int>(st);
}

int vk_jpeg_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t st = nvjpegCreateSimple(&h);
  *handle = h;
  return static_cast<int>(st);
}

int vk_jpeg_destroy(void* handle) {
  return static_cast<int>(nvjpegDestroy(static_cast<nvjpegHandle_t>(handle)));
}

int vk_jpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t s = nullptr;
  nvjpegStatus_t st =
      nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &s);
  *state = s;
  return static_cast<int>(st);
}

int vk_jpeg_state_destroy(void* state) {
  return static_cast<int>(
      nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state)));
}

// components, chroma subsampling (nvjpegChromaSubsampling_t), and the size
// of the first component, which is the image's
int vk_jpeg_info(void* handle, const void* data, size_t length, int* ncomp,
                 int* subsampling, int* width, int* height) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  nvjpegStatus_t st = nvjpegGetImageInfo(
      static_cast<nvjpegHandle_t>(handle),
      static_cast<const unsigned char*>(data), length, ncomp, &css, widths,
      heights);
  *subsampling = static_cast<int>(css);
  *width = widths[0];
  *height = heights[0];
  return static_cast<int>(st);
}

// decode into `out` with rows `pitch` bytes apart, on `stream`: interleaved
// RGB (height, width, 3) for format NVJPEG_OUTPUT_RGBI, the luma plane
// (height, width) for NVJPEG_OUTPUT_Y (a grey JPEG); returns 0, an nvJPEG
// status, or 1000 + a CUDA error
int vk_jpeg_decode(void* handle, void* state, const void* data, size_t length,
                   void* out, size_t pitch, int format, void* stream) {
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = pitch;
  nvjpegStatus_t st = nvjpegDecode(
      static_cast<nvjpegHandle_t>(handle),
      static_cast<nvjpegJpegState_t>(state),
      static_cast<const unsigned char*>(data), length,
      static_cast<nvjpegOutputFormat_t>(format), &img,
      static_cast<cudaStream_t>(stream));
  int cuda = cuda_status();  // read (and clear) it either way
  return st != NVJPEG_STATUS_SUCCESS ? static_cast<int>(st) : cuda;
}

}  // extern "C"
