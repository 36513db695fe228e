// Fused local-attention warp, backward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_warp.py::_bwd_kernel (launched by
// _warp_bwd_pallas, under the custom VJP's _core_bwd). Given the forward's
// inputs and the output cotangent g it computes d_source, d_flow (x, y),
// d_hidden_bt (= d_hpre, the cotangent of the pre-activation hidden layer),
// dW1s, dW2 and db2. Two kernels share the work:
//
//  * warp_bwd_pos_kernel, per position: recomputes the footprint, blocks,
//    hidden layer and softmax exactly as warp_fwd.cu does; then
//    d_attn = (1/k^2) <block, g>, d_logits = attn (d_attn - sum attn d_attn),
//    d_hpre = LeakyReLU'(hpre) (d_logits W2^T), and for each offset
//    d_block = d_hpre W1s^T + (1/k^2) attn g, which it scatters with atomicAdd
//    into d_source through the four clamped taps (the clamp is what
//    gfla_tpu's _fold_pad amounts to) and folds into d_flow. dW2 and db2
//    are summed per CTA into a partial buffer.
//  * warp_bwd_w1_kernel: dW1s = sum_p block_p^T d_hpre_p, a (k^2 C x N) x
//    (N x D) product. Each CTA owns kRows channels of one offset and a chunk
//    of kChunk positions, re-gathers its blocks from source and the
//    footprints instead of reading materialised blocks (419 MB at the k=5
//    site), and writes a partial sum.
//  * reduce_parts sums the partials in a fixed order, so dW1s, dW2 and db2
//    are deterministic; d_source is not (atomicAdd order).
//
// What bounds it on an H100: at the k=5 site of the DeepFashion generator
// (B=8, 64x64, C=128, D=128) each of the three dense products (the
// recomputed hidden layer, d_block, dW1s) is 8*4096 x 3200 x 128 FMAs,
// 27 GFLOP each, about 80 GFLOP in all, against a few MB of inputs: it is
// compute-bound, plus 4 k^2 C atomic adds per position for d_source. It runs
// on the FP32 cores, each shared-memory float4 read feeding four FMAs;
// tensor cores (wgmma) and a shared-memory pre-sum of the scatter are later
// work.
#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "reduce_parts.cuh"
#include "warp_common.cuh"

namespace {

using gfla::kTile;            // positions per CTA of the per-position kernel
using gfla::warp_sum;
constexpr int kRows = 32;     // dW1s rows (channels of one offset) per CTA
constexpr int kSub = 32;      // positions per shared-memory stage, dW1s
constexpr int kChunk = 1024;  // positions per partial sum of dW1s

// blockDim.x is D rounded up to a multiple of 32; thread d < D owns hidden
// unit d, as in the forward.
template <int K>
__global__ void __launch_bounds__(256)
    warp_bwd_pos_kernel(const float* __restrict__ src,
                        const float* __restrict__ flow,
                        const float* __restrict__ hbt,
                        const float* __restrict__ w1s,
                        const float* __restrict__ w2,
                        const float* __restrict__ b2,
                        const float* __restrict__ g, float* __restrict__ dsrc,
                        float* __restrict__ dflow, float* __restrict__ dhbt,
                        float* __restrict__ w2_part, int N, int H, int W,
                        int C, int Cp, int D, int Dp, float slope) {
  constexpr int K2 = K * K;
  const float inv_k2 = 1.0f / static_cast<float>(K2);
  extern __shared__ __align__(16) unsigned char smem[];
  gfla::Footprint* fp = reinterpret_cast<gfla::Footprint*>(smem);
  int* img_of = reinterpret_cast<int*>(fp + kTile);      // batch index or -1
  float* blk = reinterpret_cast<float*>(img_of + kTile);  // kTile x Cp
  float* hid = blk + kTile * Cp;  // kTile x Dp: hidden, later d_hpre
  float* att = hid + kTile * Dp;  // kTile x K2: softmax
  float* dat = att + kTile * K2;  // kTile x K2: d_attn, later d_logits
  float* dwy = dat + kTile * K2;  // kTile
  float* dwx = dwy + kTile;       // kTile

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int d = tid;
  const bool owns_d = d < D;
  const int p0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, N - p0);
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
    dwy[t] = 0.0f;
    dwx[t] = 0.0f;
  }

  // ---- recompute hpre = blocks . W1s (+ hbt), and d_attn per offset ----
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
    if (owns_d) {
      gfla::dense_accumulate(acc, blk, Cp,
                             w1s + static_cast<size_t>(m) * C * D + d, C, D);
    }
    // d_attn[t][m] = (1/k^2) <block, g>: one warp per position
    for (int t = warp; t < kTile; t += nwarps) {
      const int b = img_of[t];
      float s = 0.0f;
      if (b >= 0) {
        const float* gp = g + static_cast<size_t>(p0 + t) * C;
        for (int c = lane; c < C; c += 32) s = fmaf(blk[t * Cp + c], gp[c], s);
      }
      s = warp_sum(s);
      if (lane == 0) dat[t * K2 + m] = s * inv_k2;
    }
  }

  // ---- + target stream, LeakyReLU; hpre stays in acc ----
  if (owns_d) {
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int p = p0 + t;
      float h = acc[t];
      if (p < N) h += hbt[static_cast<size_t>(p) * D + d];
      acc[t] = h;
      hid[t * Dp + d] = h >= 0.0f ? h : h * slope;
    }
  } else if (d < Dp) {
    for (int t = 0; t < kTile; ++t) hid[t * Dp + d] = 0.0f;
  }
  __syncthreads();
  gfla::logits_softmax(hid, Dp, w2, b2, att, K2, D);
  // d_logits = attn (d_attn - sum attn d_attn); this CTA's dW2 and db2
  gfla::softmax_bwd(att, dat, n_valid, K2);
  float* part = w2_part + static_cast<size_t>(blockIdx.x) * (D * K2 + K2);
  gfla::dw2_db2_partial(hid, Dp, dat, part, D * K2, K2, D);
  __syncthreads();  // hidden fully read before d_hpre overwrites it

  // ---- d_hpre = LeakyReLU'(hpre) (d_logits . W2^T) ----
  if (owns_d) {
    gfla::d_hpre_rows(acc, dat, w2, slope, hid, Dp, dhbt, p0, n_valid, K2, D);
  }

  // ---- per offset: d_block, scattered into d_source, folded into d_flow ----
  for (int m = 0; m < K2; ++m) {
    const int i = m / K;
    const int j = m - i * K;
    __syncthreads();  // d_hpre ready; previous d_block fully consumed
    // d_block[t][c] = d_hpre[t] . W1s[m*C + c] + (1/k^2) attn[t][m] g[t][c]
    for (int c = tid; c < C; c += nthreads) {
      float a2[kTile];
#pragma unroll
      for (int t = 0; t < kTile; ++t) a2[t] = 0.0f;
      const float* wrow = w1s + (static_cast<size_t>(m) * C + c) * D;
      for (int dd = 0; dd < Dp; dd += 4) {
        float4 w;
        if (D == Dp) {  // rows are 16-byte aligned
          w = *reinterpret_cast<const float4*>(wrow + dd);
        } else {
          w.x = dd < D ? wrow[dd] : 0.0f;
          w.y = dd + 1 < D ? wrow[dd + 1] : 0.0f;
          w.z = dd + 2 < D ? wrow[dd + 2] : 0.0f;
          w.w = dd + 3 < D ? wrow[dd + 3] : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const float4 h = *reinterpret_cast<const float4*>(hid + t * Dp + dd);
          a2[t] = fmaf(h.x, w.x, a2[t]);
          a2[t] = fmaf(h.y, w.y, a2[t]);
          a2[t] = fmaf(h.z, w.z, a2[t]);
          a2[t] = fmaf(h.w, w.w, a2[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        float v = 0.0f;
        if (img_of[t] >= 0) {
          v = fmaf(inv_k2 * att[t * K2 + m],
                   g[static_cast<size_t>(p0 + t) * C + c], a2[t]);
        }
        blk[t * Cp + c] = v;
      }
    }
    __syncthreads();
    // one warp per position, lanes over channels
    for (int t = warp; t < kTile; t += nwarps) {
      const int b = img_of[t];
      if (b < 0) continue;
      const gfla::Footprint f = fp[t];
      const gfla::Taps tp = gfla::tap_pixels(f, i, j, H, W);
      const gfla::TapWeights tw = gfla::tap_weights(f.wy, f.wx);
      const float* img = src + static_cast<size_t>(b) * HW * C;
      float* dimg = dsrc + static_cast<size_t>(b) * HW * C;
      float sy = 0.0f;
      float sx = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float v = blk[t * Cp + c];
        atomicAdd(dimg + static_cast<size_t>(tp.tl) * C + c, tw.tl * v);
        atomicAdd(dimg + static_cast<size_t>(tp.tr) * C + c, tw.tr * v);
        atomicAdd(dimg + static_cast<size_t>(tp.bl) * C + c, tw.bl * v);
        atomicAdd(dimg + static_cast<size_t>(tp.br) * C + c, tw.br * v);
        const float tl = img[static_cast<size_t>(tp.tl) * C + c];
        const float tr = img[static_cast<size_t>(tp.tr) * C + c];
        const float bl = img[static_cast<size_t>(tp.bl) * C + c];
        const float br = img[static_cast<size_t>(tp.br) * C + c];
        sy = fmaf(v, gfla::dblend_dwy(f.wx, tl, tr, bl, br), sy);
        sx = fmaf(v, gfla::dblend_dwx(f.wy, tl, tr, bl, br), sx);
      }
      sy = warp_sum(sy);
      sx = warp_sum(sx);
      if (lane == 0) {  // only this warp touches position t
        dwy[t] += sy;
        dwx[t] += sx;
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < kTile; t += nthreads) {
    const int p = p0 + t;
    if (p < N) {
      dflow[2 * p] = dwx[t];  // (x, y) order, as the flow
      dflow[2 * p + 1] = dwy[t];
    }
  }
}

// dW1s partial sums: CTA (m, channel tile, chunk) writes
// part[chunk][m*C + c][d] = sum over the chunk's positions p of
// block_p[m][c] * d_hpre_p[d].
template <int K>
__global__ void __launch_bounds__(256)
    warp_bwd_w1_kernel(const float* __restrict__ src,
                       const float* __restrict__ flow,
                       const float* __restrict__ dhpre,
                       float* __restrict__ part, int N, int H, int W, int C,
                       int D, int n_ctiles) {
  constexpr int K2 = K * K;
  __shared__ gfla::Footprint fp[kSub];
  __shared__ int img_of[kSub];
  __shared__ __align__(16) float blk[kSub * kRows];
  extern __shared__ __align__(16) unsigned char smem[];
  float* dh = reinterpret_cast<float*>(smem);  // kSub x D

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int d = tid;
  const int m = blockIdx.x / n_ctiles;
  const int c0 = (blockIdx.x - m * n_ctiles) * kRows;
  const int i = m / K;
  const int j = m - i * K;
  const int HW = H * W;
  const int pbeg = blockIdx.y * kChunk;
  const int pend = min(N, pbeg + kChunk);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  for (int p0 = pbeg; p0 < pend; p0 += kSub) {
    __syncthreads();  // previous stage fully consumed
    for (int s = tid; s < kSub; s += nthreads) {
      const int p = p0 + s;
      if (p < pend) {
        const int b = p / HW;
        const int rem = p - b * HW;
        const int y = rem / W;
        const int x = rem - y * W;
        fp[s] = gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, K);
        img_of[s] = b;
      } else {
        img_of[s] = -1;
      }
    }
    for (int e = tid; e < kSub * D; e += nthreads) {
      const int s = e / D;
      const int p = p0 + s;
      dh[e] = p < pend ? dhpre[static_cast<size_t>(p0) * D + e] : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < kSub * kRows; e += nthreads) {
      const int s = e / kRows;
      const int c = c0 + (e - s * kRows);
      const int b = img_of[s];
      float v = 0.0f;
      if (b >= 0 && c < C) {
        v = gfla::block_value(src + static_cast<size_t>(b) * HW * C, fp[s],
                              i, j, c, H, W, C);
      }
      blk[e] = v;
    }
    __syncthreads();
    if (d < D) {
      for (int s = 0; s < kSub; ++s) {
        const float dv = dh[s * D + d];
#pragma unroll
        for (int r = 0; r < kRows; r += 4) {
          const float4 v = *reinterpret_cast<const float4*>(blk + s * kRows + r);
          acc[r] = fmaf(v.x, dv, acc[r]);
          acc[r + 1] = fmaf(v.y, dv, acc[r + 1]);
          acc[r + 2] = fmaf(v.z, dv, acc[r + 2]);
          acc[r + 3] = fmaf(v.w, dv, acc[r + 3]);
        }
      }
    }
  }
  if (d < D) {
    float* out = part + (static_cast<size_t>(blockIdx.y) * K2 * C +
                         static_cast<size_t>(m) * C) * D + d;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (c0 + r < C) out[static_cast<size_t>(c0 + r) * D] = acc[r];
    }
  }
}

int threads_for(int D) { return (D + 31) / 32 * 32; }

template <int K>
int launch_pos(const float* src, const float* flow, const float* hbt,
               const float* w1s, const float* w2, const float* b2,
               const float* g, float* dsrc, float* dflow, float* dhbt,
               float* w2_part, float* dw2b2, int N, int H, int W, int C,
               int D, float slope, cudaStream_t stream) {
  constexpr int K2 = K * K;
  const int Cp = (C + 3) / 4 * 4;
  const int Dp = (D + 3) / 4 * 4;
  const size_t smem = kTile * (sizeof(gfla::Footprint) + sizeof(int)) +
                      sizeof(float) * (kTile * (Cp + Dp + 2 * K2) + 2 * kTile);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        warp_bwd_pos_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_ctas = (N + kTile - 1) / kTile;
  warp_bwd_pos_kernel<K><<<n_ctas, threads_for(D), smem, stream>>>(
      src, flow, hbt, w1s, w2, b2, g, dsrc, dflow, dhbt, w2_part, N, H, W, C,
      Cp, D, Dp, slope);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return gfla::launch_reduce(w2_part, n_ctas,
                             static_cast<size_t>(D) * K2 + K2, dw2b2, stream);
}

template <int K>
int launch_w1(const float* src, const float* flow, const float* dhpre,
              float* part, float* dw1s, int N, int H, int W, int C, int D,
              cudaStream_t stream) {
  constexpr int K2 = K * K;
  const int n_ctiles = (C + kRows - 1) / kRows;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * kSub * D;
  const dim3 grid(K2 * n_ctiles, n_chunks);
  warp_bwd_w1_kernel<K><<<grid, threads_for(D), smem, stream>>>(
      src, flow, dhpre, part, N, H, W, C, D, n_ctiles);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return gfla::launch_reduce(part, n_chunks, static_cast<size_t>(K2) * C * D,
                             dw1s, stream);
}

}  // namespace

// Scratch sizes, in floats, that the wrapper allocates for the partial sums.
extern "C" long long gfla_warp_bwd_pos_scratch(int N, int D, int k) {
  return static_cast<long long>((N + kTile - 1) / kTile) * (D * k * k + k * k);
}

extern "C" long long gfla_warp_bwd_w1_scratch(int N, int C, int D, int k) {
  return static_cast<long long>((N + kChunk - 1) / kChunk) * k * k * C * D;
}

// Per-position backward. Inputs as gfla_warp_fwd, plus g (B,H,W,C). Outputs:
// dsrc (B,H,W,C), zeroed by the caller (atomicAdd target); dflow (B,H,W,2)
// in (x, y) order; dhbt (B*H*W, D); dw2b2 (D*k*k + k*k): dW2 (D, k*k)
// followed by db2. w2_part: gfla_warp_bwd_pos_scratch floats. Returns a
// cudaError_t; 0 means both launches were accepted.
extern "C" int gfla_warp_bwd_pos(const float* src, const float* flow,
                                 const float* hbt, const float* w1s,
                                 const float* w2, const float* b2,
                                 const float* g, float* dsrc, float* dflow,
                                 float* dhbt, float* w2_part, float* dw2b2,
                                 int B, int H, int W, int C, int D, int k,
                                 float slope, void* stream) {
  const int N = B * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GFLA_POS(K)                                                          \
  launch_pos<K>(src, flow, hbt, w1s, w2, b2, g, dsrc, dflow, dhbt, w2_part, \
                dw2b2, N, H, W, C, D, slope, s)
  switch (k) {
    case 1: return GFLA_POS(1);
    case 3: return GFLA_POS(3);
    case 5: return GFLA_POS(5);
    case 7: return GFLA_POS(7);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GFLA_POS
}

// dW1s (k*k*C, D) from source, flow and d_hpre (B*H*W, D). part:
// gfla_warp_bwd_w1_scratch floats. Returns a cudaError_t.
extern "C" int gfla_warp_bwd_w1(const float* src, const float* flow,
                                const float* dhpre, float* part, float* dw1s,
                                int B, int H, int W, int C, int D, int k,
                                void* stream) {
  const int N = B * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_w1<1>(src, flow, dhpre, part, dw1s, N, H, W, C, D, s);
    case 3: return launch_w1<3>(src, flow, dhpre, part, dw1s, N, H, W, C, D, s);
    case 5: return launch_w1<5>(src, flow, dhpre, part, dw1s, N, H, W, C, D, s);
    case 7: return launch_w1<7>(src, flow, dhpre, part, dw1s, N, H, W, C, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
