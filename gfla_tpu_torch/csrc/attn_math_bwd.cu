// Local-attention math over gathered blocks, backward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_attn.py::_bwd_kernel (launched by
// _attn_math_bwd_pallas under the custom VJP attn_math_fused). Given the
// forward's inputs and the output cotangent g (N, C), it recomputes the
// forward per position and writes
//     d_bs   = d_hpre . W1s^T + (1/k^2) attn g        (N, k^2, C)
//     d_bt   = d_hpre . W1t^T                         (N, k^2, C)
//     d_hpre = LeakyReLU'(hpre) (d_logits . W2^T)     (N, D)
// with d_logits = attn (d_attn - sum attn d_attn), d_attn = (1/k^2) <bs, g>,
// and the sums over positions dW2 = hidden^T d_logits, db1 = sum d_hpre,
// db2 = sum d_logits. dW1 = [bt || bs]^T d_hpre is one matrix product outside
// the kernel, as gfla_tpu computes it outside its kernel.
//
// The TPU adds dW2, db1 and db2 across its sequential grid. CUDA CTAs run in
// no order, so each CTA writes its partial sums and gfla::reduce_parts adds
// them in CTA order: the weight gradients are deterministic. d_bs and d_bt are
// written once per element, with no atomics.
//
// What bounds it on an H100: at the k=5 site (N = 8*64*64, k^2 = 25, C = 128,
// D = 128) the recomputed dense layer and d_[bs||bt] are 53.7 GFLOP each,
// 107 GFLOP in all, 1.6 ms at the f32 peak, against 1.7 GB of block reads and
// writes (0.51 ms at 3.35 TB/s): compute-bound, on the FP32 cores.
//
// What this design does about it: a CTA of kTile positions and one thread per
// hidden unit recomputes hpre as attn_math_fwd.cu does (register accumulators
// over shared-memory rows of bt and bs) and runs the softmax and LeakyReLU
// backward steps it shares with warp_bwd.cu (attn_tile.cuh). Then, for each
// offset, one thread per channel streams the W1t and W1s rows of that channel
// against the CTA's d_hpre in shared memory, keeping 2 * kTile sums in
// registers.
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "reduce_parts.cuh"

namespace {

using gfla::kTile;

// blockDim.x is D rounded up to a multiple of 32; thread d < D owns hidden
// unit d.
__global__ void __launch_bounds__(256)
    attn_math_bwd_kernel(const float* __restrict__ bs,
                         const float* __restrict__ bt,
                         const float* __restrict__ g,
                         const float* __restrict__ w1t,
                         const float* __restrict__ w1s,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         float* __restrict__ d_bs, float* __restrict__ d_bt,
                         float* __restrict__ d_hpre, float* __restrict__ part,
                         int N, int K2, int C, int Cp, int D, int Dp,
                         float slope) {
  const float inv_k2 = 1.0f / static_cast<float>(K2);
  extern __shared__ __align__(16) unsigned char smem[];
  float* blk_t = reinterpret_cast<float*>(smem);  // kTile x Cp
  float* blk_s = blk_t + kTile * Cp;              // kTile x Cp
  float* hid = blk_s + kTile * Cp;  // kTile x Dp: hidden, later d_hpre
  float* att = hid + kTile * Dp;    // kTile x K2: softmax
  float* dat = att + kTile * K2;    // kTile x K2: d_attn, later d_logits

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int d = tid;
  const bool owns_d = d < D;
  const int p0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, N - p0);

  // ---- recompute hpre = bt . W1t + bs . W1s, and d_attn per offset ----
  float acc[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) acc[t] = 0.0f;

  for (int m = 0; m < K2; ++m) {
    __syncthreads();  // the previous offset's rows are consumed
    gfla::stage_offset_pair(bt, bs, m, p0, n_valid, K2, C, Cp, blk_t, blk_s);
    __syncthreads();
    if (owns_d) {
      const size_t w = static_cast<size_t>(m) * C * D + d;
      gfla::dense_accumulate_pair(acc, blk_t, w1t + w, blk_s, w1s + w, Cp, C,
                                  D);
    }
    // d_attn[t][m] = (1/k^2) <bs, g>: one warp per position
    for (int t = warp; t < kTile; t += nwarps) {
      float s = 0.0f;
      if (t < n_valid) {
        const float* gp = g + static_cast<size_t>(p0 + t) * C;
        for (int c = lane; c < C; c += 32) s = fmaf(blk_s[t * Cp + c], gp[c], s);
      }
      s = gfla::warp_sum(s);
      if (lane == 0) dat[t * K2 + m] = s * inv_k2;
    }
  }

  // ---- + b1, LeakyReLU; hpre stays in acc ----
  if (owns_d) {
    const float bias = b1[d];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float h = acc[t] + bias;
      acc[t] = h;
      hid[t * Dp + d] = h >= 0.0f ? h : h * slope;
    }
  } else if (d < Dp) {
    for (int t = 0; t < kTile; ++t) hid[t * Dp + d] = 0.0f;
  }
  __syncthreads();
  gfla::logits_softmax(hid, Dp, w2, b2, att, K2, D);
  // d_logits = attn (d_attn - sum attn d_attn); this CTA's dW2, db2, db1
  gfla::softmax_bwd(att, dat, n_valid, K2);
  float* my_part = part + static_cast<size_t>(blockIdx.x) * (D * K2 + D + K2);
  gfla::dw2_db2_partial(hid, Dp, dat, my_part, D * K2 + D, K2, D);
  __syncthreads();  // hidden fully read before d_hpre overwrites it

  // ---- d_hpre = LeakyReLU'(hpre) (d_logits . W2^T), and db1 ----
  if (owns_d) {
    my_part[D * K2 + d] = gfla::d_hpre_rows(acc, dat, w2, slope, hid, Dp,
                                            d_hpre, p0, n_valid, K2, D);
  }
  __syncthreads();

  // ---- per offset: d_bt = d_hpre . W1t^T, d_bs = d_hpre . W1s^T + attn g ----
  for (int m = 0; m < K2; ++m) {
    for (int c = tid; c < C; c += nthreads) {
      float at[kTile], as[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        at[t] = 0.0f;
        as[t] = 0.0f;
      }
      const float* wt = w1t + (static_cast<size_t>(m) * C + c) * D;
      const float* ws = w1s + (static_cast<size_t>(m) * C + c) * D;
      for (int dd = 0; dd < Dp; dd += 4) {
        float4 u, v;
        if (D == Dp) {  // rows are 16-byte aligned
          u = *reinterpret_cast<const float4*>(wt + dd);
          v = *reinterpret_cast<const float4*>(ws + dd);
        } else {
          u.x = dd < D ? wt[dd] : 0.0f;
          u.y = dd + 1 < D ? wt[dd + 1] : 0.0f;
          u.z = dd + 2 < D ? wt[dd + 2] : 0.0f;
          u.w = dd + 3 < D ? wt[dd + 3] : 0.0f;
          v.x = dd < D ? ws[dd] : 0.0f;
          v.y = dd + 1 < D ? ws[dd + 1] : 0.0f;
          v.z = dd + 2 < D ? ws[dd + 2] : 0.0f;
          v.w = dd + 3 < D ? ws[dd + 3] : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const float4 h = *reinterpret_cast<const float4*>(hid + t * Dp + dd);
          at[t] = fmaf(h.x, u.x, at[t]);
          at[t] = fmaf(h.y, u.y, at[t]);
          at[t] = fmaf(h.z, u.z, at[t]);
          at[t] = fmaf(h.w, u.w, at[t]);
          as[t] = fmaf(h.x, v.x, as[t]);
          as[t] = fmaf(h.y, v.y, as[t]);
          as[t] = fmaf(h.z, v.z, as[t]);
          as[t] = fmaf(h.w, v.w, as[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (t >= n_valid) continue;
        const int p = p0 + t;
        const size_t off = (static_cast<size_t>(p) * K2 + m) * C + c;
        d_bt[off] = at[t];
        d_bs[off] = fmaf(inv_k2 * att[t * K2 + m],
                         g[static_cast<size_t>(p) * C + c], as[t]);
      }
    }
  }
}

}  // namespace

// Scratch size, in floats, that the wrapper allocates for the partial sums.
extern "C" long long gfla_attn_math_bwd_scratch(int N, int k2, int D) {
  return static_cast<long long>((N + kTile - 1) / kTile) *
         (static_cast<long long>(D) * k2 + D + k2);
}

// Inputs as gfla_attn_math_fwd, plus g (N, C). Outputs: d_bs, d_bt
// (N, k2, C); d_hpre (N, D); sums (D*k2 + D + k2): dW2 (D, k2), then db1 (D),
// then db2 (k2). part: gfla_attn_math_bwd_scratch floats. Returns a
// cudaError_t; 0 means both launches were accepted.
extern "C" int gfla_attn_math_bwd(const float* bs, const float* bt,
                                  const float* g, const float* w1t,
                                  const float* w1s, const float* b1,
                                  const float* w2, const float* b2,
                                  float* d_bs, float* d_bt, float* d_hpre,
                                  float* part, float* sums, int N, int k2,
                                  int C, int D, float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Cp = (C + 3) / 4 * 4;
  const int Dp = (D + 3) / 4 * 4;
  const size_t smem = sizeof(float) * kTile * (2 * Cp + Dp + 2 * k2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_math_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (D + 31) / 32 * 32;
  const int n_ctas = (N + kTile - 1) / kTile;
  attn_math_bwd_kernel<<<n_ctas, threads, smem, st>>>(
      bs, bt, g, w1t, w1s, b1, w2, b2, d_bs, d_bt, d_hpre, part, N, k2, C, Cp,
      D, Dp, slope);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return gfla::launch_reduce(part, n_ctas,
                             static_cast<size_t>(D) * k2 + D + k2, sums, st);
}
