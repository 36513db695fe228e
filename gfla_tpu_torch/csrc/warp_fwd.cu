// Fused local-attention warp, forward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_warp.py::_fwd_kernel (launched by
// _warp_fwd_pallas). Per output position it gathers the flow-displaced,
// edge-clamped k x k source block (bilinear, shared fractional weights),
// computes hidden = blocks . W1s + hidden_bt, LeakyReLU, logits = hidden . W2
// + b2, a softmax over the k^2 offsets, and out = (1/k^2) sum attn * block.
// The target stream hidden_bt (a plain k x k convolution plus b1) is computed
// outside, as gfla_tpu does.
//
// What bounds it on this card: at the k=5 site of the DeepFashion generator
// (B=8, 64x64, C=128, D=128) the dense layer is 8*4096 positions x 3200 x 128
// FMAs, about 27 GFLOP, against a few MB of source, flow and hidden_bt and a
// 1.6 MB W1s that stays in the 50 MB L2. It is compute-bound.
//
// What this design does about it: a CTA takes kTile positions and D threads,
// one per hidden unit, each keeping its kTile partial sums in registers. For
// each of the k^2 offsets the CTA blends that offset's (kTile x C) block into
// shared memory once, and every thread streams its W1s column against it, so
// each W1s element is read once per CTA and each shared-memory read feeds
// four FMAs (float4 broadcast). The softmax stage re-gathers the blocks from
// L1/L2 instead of keeping k^2 * C floats per position. It runs on the FP32
// cores: moving the dense layer to wgmma with TMA-fed tiles is later work.
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "warp_common.cuh"

namespace {

using gfla::kTile;

template <int K>
__global__ void __launch_bounds__(256)
    warp_fwd_kernel(const float* __restrict__ src,
                    const float* __restrict__ flow,
                    const float* __restrict__ hbt,
                    const float* __restrict__ w1s,
                    const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int N, int H, int W, int C, int Cp, int D, float slope) {
  constexpr int K2 = K * K;
  extern __shared__ __align__(16) unsigned char smem[];
  gfla::Footprint* fp = reinterpret_cast<gfla::Footprint*>(smem);
  int* img_of = reinterpret_cast<int*>(fp + kTile);      // batch index or -1
  float* blk = reinterpret_cast<float*>(img_of + kTile);  // kTile x Cp
  float* hid = blk + kTile * Cp;                          // kTile x D
  float* att = hid + kTile * D;                           // kTile x K2

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int d = tid;  // blockDim.x == D: one hidden unit per thread
  const int p0 = blockIdx.x * kTile;
  const int HW = H * W;

  for (int t = tid; t < kTile; t += nthreads) {
    const int p = p0 + t;
    if (p < N) {
      const int b = p / HW;
      const int rem = p - b * HW;
      const int y = rem / W;
      const int x = rem - y * W;
      fp[t] = gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, K);
      img_of[t] = b;
    } else {
      fp[t] = gfla::Footprint{0, 0, 0.0f, 0.0f};
      img_of[t] = -1;
    }
  }

  // hidden = blocks . W1s, accumulated over the k^2 offsets
  float acc[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;

  for (int m = 0; m < K2; ++m) {
    const int i = m / K;
    const int j = m - i * K;
    __syncthreads();  // footprints ready; previous block fully consumed
    for (int e = tid; e < kTile * Cp; e += nthreads) {
      const int t = e / Cp;
      const int c = e - t * Cp;
      const int b = img_of[t];
      float v = 0.0f;
      if (b >= 0 && c < C) {
        v = gfla::block_value(src + static_cast<size_t>(b) * HW * C, fp[t],
                              i, j, c, H, W, C);
      }
      blk[e] = v;
    }
    __syncthreads();
    gfla::dense_accumulate(acc, blk, Cp,
                           w1s + static_cast<size_t>(m) * C * D + d, C, D);
  }

  // + target stream (which carries b1), LeakyReLU
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    const int p = p0 + t;
    float h = acc[t];
    if (p < N) h += hbt[static_cast<size_t>(p) * D + d];
    hid[t * D + d] = h >= 0.0f ? h : h * slope;
  }
  __syncthreads();
  gfla::logits_softmax(hid, D, w2, b2, att, K2, D);

  // out = (1/k^2) sum attn * block, re-gathering each block
  for (int e = tid; e < kTile * C; e += nthreads) {
    const int t = e / C;
    const int c = e - t * C;
    const int b = img_of[t];
    if (b < 0) continue;
    const float* img = src + static_cast<size_t>(b) * HW * C;
    float o = 0.0f;
    for (int mm = 0; mm < K2; ++mm) {
      const int i = mm / K;
      const int j = mm - i * K;
      o = fmaf(att[t * K2 + mm],
               gfla::block_value(img, fp[t], i, j, c, H, W, C), o);
    }
    out[static_cast<size_t>(p0 + t) * C + c] = o / static_cast<float>(K2);
  }
}

template <int K>
int launch(const float* src, const float* flow, const float* hbt,
           const float* w1s, const float* w2, const float* b2, float* out,
           int N, int H, int W, int C, int D, float slope,
           cudaStream_t stream) {
  const int Cp = (C + 3) / 4 * 4;
  const size_t smem = kTile * (sizeof(gfla::Footprint) + sizeof(int)) +
                      sizeof(float) * kTile * (Cp + D + K * K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_fwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((N + kTile - 1) / kTile);
  warp_fwd_kernel<K><<<grid, D, smem, stream>>>(src, flow, hbt, w1s, w2, b2,
                                                  out, N, H, W, C, Cp, D, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// source (B,H,W,C), flow (B,H,W,2) as (x, y), hbt (B*H*W, D), w1s (k*k*C, D),
// w2 (D, k*k), b2 (k*k), out (B,H,W,C): float32, contiguous, on one device.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int gfla_warp_fwd(const float* src, const float* flow,
                             const float* hbt, const float* w1s,
                             const float* w2, const float* b2, float* out,
                             int B, int H, int W, int C, int D, int k,
                             float slope, void* stream) {
  const int N = B * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(src, flow, hbt, w1s, w2, b2, out, N, H, W, C, D, slope, s);
    case 3: return launch<3>(src, flow, hbt, w1s, w2, b2, out, N, H, W, C, D, slope, s);
    case 5: return launch<5>(src, flow, hbt, w1s, w2, b2, out, N, H, W, C, D, slope, s);
    case 7: return launch<7>(src, flow, hbt, w1s, w2, b2, out, N, H, W, C, D, slope, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gfla_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
