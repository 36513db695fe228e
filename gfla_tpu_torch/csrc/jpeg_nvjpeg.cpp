// JPEG decode and encode on the card through nvJPEG, with a plain C
// interface for ctypes (gfla_tpu_torch/data/image_io.py).
//
// Replaces the image reads and writes of gfla_tpu's host pipeline
// (gfla_tpu/data/paired_dataset.py:79-83,97-101 through PIL,
// gfla_tpu/tasks/testing.py:27-31 and gfla_tpu/utils/visualizer.py:83
// through imageio), which the card's machine cannot run: it has no image
// library. Not a TPU kernel (gfla_tpu decodes on the host): the loader's
// workers pass the JPEG bytes, and the decode writes straight into tensors
// on the device, on PyTorch's current stream.
//
// Decode: nvjpegDecode, one image a call and one state, on a stream of the
// decoder's own (data/image_io.py), each call waiting for its image: the
// state keeps the image's bitstream in host buffers that the next call
// overwrites, so a decode left queued behind other work (a training step
// on the same stream) would read the next image's data. To the component
// planes (NVJPEG_OUTPUT_YUV, or NVJPEG_OUTPUT_Y for grey):
// data/image_io.py upsamples the chroma and converts to RGB in torch with
// libjpeg's arithmetic, which is what PIL, gfla_tpu's decoder, runs
// (nvJPEG's own RGB output upsamples the chroma otherwise, and lands
// levels away from PIL's at colour edges). Encode: nvjpegEncodeImage from interleaved RGB at
// the given quality with 4:2:0 chroma (PIL's and imageio's defaults), then
// the bitstream is copied to the host. Every call returns 0, an nvjpeg
// status (1-99) or 1000 + a CUDA error; the wrapper raises on anything else
// than 0 and names the file. Nothing here falls back to another decoder.
//
// Built by gfla_tpu_torch/ops/_build.py with nvcc as host code, linked with
// -lnvjpeg from the CUDA toolkit.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>

namespace {

struct JpegContext {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int enc_quality = -1;
};

constexpr int kCudaErrorBase = 1000;

int cuda_status(cudaError_t err) {
  return err == cudaSuccess ? 0 : kCudaErrorBase + static_cast<int>(err);
}

}  // namespace

extern "C" {

int gfla_jpeg_create(void** out) {
  auto* ctx = new JpegContext();
  int s = nvjpegCreateSimple(&ctx->handle);
  if (s == 0) s = nvjpegJpegStateCreate(ctx->handle, &ctx->state);
  if (s != 0) {
    if (ctx->handle) nvjpegDestroy(ctx->handle);
    delete ctx;
    return s;
  }
  *out = ctx;
  return 0;
}

// The image's component count, chroma subsampling (nvjpegChromaSubsampling_t)
// and each component's height and width (4 entries each).
int gfla_jpeg_info(void* handle, const unsigned char* data, size_t length,
                   int* components, int* subsampling, int* heights,
                   int* widths) {
  auto* ctx = static_cast<JpegContext*>(handle);
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  int s = nvjpegGetImageInfo(ctx->handle, data, length, components, &css,
                             widths, heights);
  *subsampling = static_cast<int>(css);
  return s;
}

// Decode to `format` (nvjpegOutputFormat_t): NVJPEG_OUTPUT_YUV writes the
// component planes at their own sizes into out0..out2 (pitch = the plane's
// width), NVJPEG_OUTPUT_Y the luma plane into out0.
int gfla_jpeg_decode(void* handle, const unsigned char* data, size_t length,
                     int format, unsigned char* out0, unsigned char* out1,
                     unsigned char* out2, int pitch0, int pitch1, int pitch2,
                     void* stream) {
  auto* ctx = static_cast<JpegContext*>(handle);
  nvjpegImage_t image = {};
  image.channel[0] = out0;
  image.channel[1] = out1;
  image.channel[2] = out2;
  image.pitch[0] = static_cast<size_t>(pitch0);
  image.pitch[1] = static_cast<size_t>(pitch1);
  image.pitch[2] = static_cast<size_t>(pitch2);
  auto st = static_cast<cudaStream_t>(stream);
  int s = nvjpegDecode(ctx->handle, ctx->state, data, length,
                       static_cast<nvjpegOutputFormat_t>(format), &image, st);
  if (s != 0) return s;
  return cuda_status(cudaStreamSynchronize(st));
}

// Encode `rgb`, height x width x 3 bytes on the device, and leave the
// bitstream in the context; *length gets its size in bytes.
int gfla_jpeg_encode(void* handle, const unsigned char* rgb, int height,
                     int width, int quality, void* stream, size_t* length) {
  auto* ctx = static_cast<JpegContext*>(handle);
  auto st = static_cast<cudaStream_t>(stream);
  int s = 0;
  if (ctx->enc_state == nullptr) {
    s = nvjpegEncoderStateCreate(ctx->handle, &ctx->enc_state, st);
    if (s == 0) s = nvjpegEncoderParamsCreate(ctx->handle, &ctx->enc_params,
                                              st);
    if (s == 0) s = nvjpegEncoderParamsSetSamplingFactors(
        ctx->enc_params, NVJPEG_CSS_420, st);
    if (s != 0) return s;
  }
  if (quality != ctx->enc_quality) {
    s = nvjpegEncoderParamsSetQuality(ctx->enc_params, quality, st);
    if (s != 0) return s;
    ctx->enc_quality = quality;
  }
  nvjpegImage_t image = {};
  image.channel[0] = const_cast<unsigned char*>(rgb);
  image.pitch[0] = static_cast<size_t>(width) * 3;
  s = nvjpegEncodeImage(ctx->handle, ctx->enc_state, ctx->enc_params, &image,
                        NVJPEG_INPUT_RGBI, width, height, st);
  if (s != 0) return s;
  s = cuda_status(cudaStreamSynchronize(st));
  if (s != 0) return s;
  return nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, nullptr,
                                       length, st);
}

// Copy the last encoded bitstream, *length bytes, to the host buffer `out`.
int gfla_jpeg_encode_fetch(void* handle, unsigned char* out, size_t* length,
                           void* stream) {
  auto* ctx = static_cast<JpegContext*>(handle);
  auto st = static_cast<cudaStream_t>(stream);
  int s = nvjpegEncodeRetrieveBitstream(ctx->handle, ctx->enc_state, out,
                                        length, st);
  if (s != 0) return s;
  return cuda_status(cudaStreamSynchronize(st));
}

// The enumerators the wrapper passes and reads, so that Python never
// restates nvjpeg.h: output formats YUV and Y, then subsamplings 4:4:4,
// 4:2:2, 4:2:0 and grey.
void gfla_jpeg_constants(int* out) {
  const int values[] = {NVJPEG_OUTPUT_YUV, NVJPEG_OUTPUT_Y, NVJPEG_CSS_444,
                        NVJPEG_CSS_422,    NVJPEG_CSS_420,  NVJPEG_CSS_GRAY};
  for (int i = 0; i < 6; ++i) out[i] = values[i];
}

const char* gfla_jpeg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
