// Local-attention math over gathered blocks, forward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_attn.py::_kernel (launched by
// _attn_math_pallas). The blocks are already gathered: bs, bt (N, k^2, C).
// Per position it computes
//     hidden = LeakyReLU(bt . W1t + bs . W1s + b1)    (D units)
//     attn   = softmax(hidden . W2 + b2)              (over the k^2 offsets)
//     out    = (1/k^2) sum_m attn_m * bs_m            (C channels)
// where W1t and W1s are the target and source halves of W1 (k^2, 2C, D), so
// the [bt || bs] concatenation is never built (gfla_tpu's _split_w1).
//
// What bounds it on an H100: at the k=5 site of the DeepFashion generator
// (N = 8*64*64, k^2 = 25, C = 128, D = 128) the dense layer is 2 * N * 6400 *
// 128 = 53.7 GFLOP, 0.80 ms at the 67 TFLOP/s f32 peak, against 839 MB of
// bs and bt, 0.25 ms at 3.35 TB/s: compute-bound, on the FP32 cores.
//
// What this design does about it: the CTA design of warp_fwd.cu without the
// gather, sharing its steps (attn_tile.cuh). A CTA takes kTile positions and
// one thread per hidden unit, each keeping kTile partial sums in registers.
// For each offset it stages that offset's (kTile x C) rows of bt and bs in
// shared memory (coalesced rows of C floats) and every thread streams its W1t
// and W1s columns against them, so each weight is read once per CTA and each
// shared-memory float4 feeds four FMAs. The weighted sum re-reads the bs rows
// from L2 rather than keep k^2 * C floats per position on chip.
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace {

using gfla::kTile;

__global__ void __launch_bounds__(256)
    attn_math_fwd_kernel(const float* __restrict__ bs,
                         const float* __restrict__ bt,
                         const float* __restrict__ w1t,
                         const float* __restrict__ w1s,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, float* __restrict__ out,
                         int N, int K2, int C, int Cp, int D, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* blk_t = reinterpret_cast<float*>(smem);  // kTile x Cp
  float* blk_s = blk_t + kTile * Cp;              // kTile x Cp
  float* hid = blk_s + kTile * Cp;                // kTile x D
  float* att = hid + kTile * D;                   // kTile x K2

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int d = tid;  // hidden unit of this thread, if d < D
  const int p0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, N - p0);

  // hpre = bt . W1t + bs . W1s, accumulated over the k^2 offsets
  float acc[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;

  for (int m = 0; m < K2; ++m) {
    __syncthreads();  // the previous offset's rows are consumed
    gfla::stage_offset_pair(bt, bs, m, p0, n_valid, K2, C, Cp, blk_t, blk_s);
    __syncthreads();
    if (d < D) {
      const size_t w = static_cast<size_t>(m) * C * D + d;
      gfla::dense_accumulate_pair(acc, blk_t, w1t + w, blk_s, w1s + w, Cp, C,
                                  D);
    }
  }

  // + b1, LeakyReLU
  if (d < D) {
    const float bias = b1[d];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float h = acc[t] + bias;
      hid[t * D + d] = h >= 0.0f ? h : h * slope;
    }
  }
  __syncthreads();

  // logits = hidden . W2 + b2, then the softmax over the k^2 offsets. Not
  // gfla::logits_softmax: inlined from there this kernel ran slower on an
  // H100, with the same arithmetic.
  for (int e = tid; e < kTile * K2; e += nthreads) {
    const int t = e / K2;
    const int mm = e - t * K2;
    float s = 0.0f;
    for (int dd = 0; dd < D; ++dd) {
      s = fmaf(hid[t * D + dd], w2[dd * K2 + mm], s);
    }
    att[e] = s + b2[mm];
  }
  __syncthreads();
  for (int t = tid; t < kTile; t += nthreads) {
    float* a = att + t * K2;
    float mx = a[0];
    for (int mm = 1; mm < K2; ++mm) mx = fmaxf(mx, a[mm]);
    float sum = 0.0f;
    for (int mm = 0; mm < K2; ++mm) {
      a[mm] = expf(a[mm] - mx);
      sum += a[mm];
    }
    for (int mm = 0; mm < K2; ++mm) a[mm] = a[mm] / sum;
  }
  __syncthreads();

  // out = (1/k^2) sum attn * bs
  for (int e = tid; e < n_valid * C; e += nthreads) {
    const int t = e / C;
    const int c = e - t * C;
    const float* row = bs + static_cast<size_t>(p0 + t) * K2 * C + c;
    float o = 0.0f;
    for (int mm = 0; mm < K2; ++mm) {
      o = fmaf(att[t * K2 + mm], row[static_cast<size_t>(mm) * C], o);
    }
    out[static_cast<size_t>(p0 + t) * C + c] = o / static_cast<float>(K2);
  }
}

}  // namespace

// bs, bt (N, k2, C); w1t, w1s (k2*C, D), the target and source halves of
// W1; b1 (D); w2 (D, k2); b2 (k2); out (N, C): float32, contiguous, on one
// device. Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int gfla_attn_math_fwd(const float* bs, const float* bt,
                                  const float* w1t, const float* w1s,
                                  const float* b1, const float* w2,
                                  const float* b2, float* out, int N, int k2,
                                  int C, int D, float slope, void* stream) {
  const int Cp = (C + 3) / 4 * 4;
  const size_t smem = sizeof(float) * kTile * (2 * Cp + D + k2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_math_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (D + 31) / 32 * 32;
  const dim3 grid((N + kTile - 1) / kTile);
  attn_math_fwd_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      bs, bt, w1t, w1s, b1, w2, b2, out, N, k2, C, Cp, D, slope);
  return static_cast<int>(cudaGetLastError());
}
