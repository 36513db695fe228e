// Fused local-attention warp, backward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_warp.py::_bwd_kernel (launched by
// _warp_bwd_pallas, under the custom VJP's _core_bwd). Given the forward's
// inputs, its pre-activation hidden layer hpre (stored by warp_fwd.cu's
// epilogue, so nothing is recomputed) and the output cotangent g it
// computes d_source, d_flow (x, y), d_hidden_bt (= d_hpre), dW1s, dW2 and
// db2. Two kernels share the work:
//
//  * warp_bwd_pos_kernel, per position: hidden = LeakyReLU(hpre), logits,
//    softmax; d_attn = (1/k^2) <block, g> as the blend of the (k+1)^2
//    footprint-cell dots <src[cell], g> (csrc/warp_cells.cuh);
//    d_logits = attn (d_attn - sum attn d_attn); dW2 and db2 per CTA;
//    d_hpre = LeakyReLU'(hpre) (d_logits W2^T); then d_block = d_hpre W1s^T
//    + (1/k^2) attn g, pre-summed over the footprint cells and added into
//    d_source, and d_flow = sum over cells of <src[cell], E[cell]>.
//  * warp_bwd_w1_kernel: dW1s = sum_p block_p^T d_hpre_p, an implicit GEMM
//    whose depth is the positions, split over position ranges.
//  * reduce_parts sums the partials in a fixed order, so dW1s, dW2, db2 and
//    d_flow are deterministic; d_source is not (the order of its vector
//    reductions).
//
// What bounds it on an H100: at the k=5 site of the DeepFashion generator
// (B=8, 64x64, C=128, D=128) each of the two dense products (d_block and
// dW1s) is 8*4096 x 3200 x 128 FMAs, 27 GFLOP, against a few MB of inputs:
// operations. Both run on the tensor cores as split-f32 products
// (mma_tf32x3.cuh): three TF32 products per f32 product, so the bound is
// 495 / 3 = 165 TFLOP/s of f32 work; mma.sync m16n8k8 from register
// fragments, split at fragment load, as in warp_fwd.cu.
//
// What the design does about it:
//  * per-position: a CTA of 4 warps owns 64 positions, 16 a warp, two CTAs
//    an SM. The product's columns are ordered so that one tile holds all
//    k^2 offsets of 8 channels (one m16n8k8 fragment per offset; in the
//    run-time instance below, a band of one offset row), so each lane ends
//    with every offset's d_block of the band for its rows and channels in
//    registers. W1s comes through a 3-stage
//    cp.async ring, 16 hidden units a stage. The
//    epilogue trades halves with the neighbouring lane (one row x 4
//    channels a lane), adds (1/k^2) attn g, and for each footprint cell
//    sums the <= 4 d_block vectors that use it as a tap: one 4-channel
//    red.global.add.v4.f32 per cell instead of 4 k^2 scalar atomicAdds per
//    channel, and d_flow from one 16-byte load of the cell. When a CTA's
//    positions leave SMs idle (the k=3 site) its channel groups are split
//    over CTAs, each with its own d_flow partial.
//  * dW1s: a CTA owns 128 hidden units x (all offsets of 4-8 channels) and
//    walks a range of positions 32 at a time. Each position's footprint
//    cells come by cp.async, a chunk ahead, with the d_hpre rows; all
//    threads blend the k^2 offsets from them into the product's tile, split
//    into its TF32 hi and lo parts there, once per value. Each
//    32-position stage is accumulated from 0 and added to the sum on the
//    FP32 cores (the tensor cores add by truncation).
//
// bf16 (warp_bwd_bf16.cu builds this file with GFLA_WARP_BF16 = 1, entries
// gfla_warp_bwd_pos_bf16 and gfla_warp_bwd_w1_bf16): gfla_tpu's backward
// with a bf16 source (pallas_warp.py:456-481). They read the source, g and
// W2 in bf16 and blend in f32 (the dW1s kernel copies the footprint cells
// as bf16), and W1s widened to f32 by the wrapper (exact), so the W1s ring is
// the f32 kernel's. Where gfla_tpu's body rounds to bf16, these do: the hidden
// layer before W2 (:286) and d_logits before W2^T (:305), d_hpre, which
// d_hidden_bt, dW1s and d_block are taken from (:308), and d_block before
// the scatter and d_flow (:319); every sum stays f32, and d_source is
// accumulated in f32 and rounded by the wrapper, as gfla_tpu's f32 dsrc_pad
// is (:400, :470). d_block and dW1s are one bf16 mma.sync m16n8k16 per 16
// deep (mma_bf16.cuh), so the bound is the tensor cores' 989 TFLOP/s bf16
// rate. The cell dots take d_attn from the unrounded blend.
//
// Block sizes: each kernel is compiled for the live sites' k (3, 5) and once
// with k taken at run time (KT = 0) for every other k in 1..9, odd or even
// (gfla_tpu's block_extract offsets i - k/2, so an even block reaches one row
// and column further up and left than down and right; the footprint in
// warp_common.cuh follows it). The run-time instance keeps its register
// arrays at their widest (k = 9) and indexes them only with loop counters
// that are unrolled to that width: the per-position product takes one offset
// row a band, the cell dots one footprint row a pass over the channels, and
// the dW1s tile its widest column count (warp_bwd_tiles.cuh).
//
// Above k = 9, the wide instances (KT < 0), which take every k gfla_tpu's
// Pallas warp does: nothing in them sized by k is held in registers or
// shared memory.
//  * The per-position backward is two kernels. warp_bwd_wide_prep_kernel
//    does what the first half of warp_bwd_pos_kernel does (softmax, cell
//    dots, d_attn, d_logits, the dW2/db2 partial, d_hpre) with the
//    per-offset and per-cell rows in device memory (N x k^2 and
//    N x (k+1)^2 floats of scratch), a warp per position in strides of 32
//    offsets or cells; warp_bwd_pos_kernel's wide instance then reads d_hpre
//    and the softmax back and runs the product and its epilogue as above,
//    its bands runs of up to kWideCols offsets of one offset row
//    (warp_bwd_tiles.cuh's wide_band), each pre-summing the 2 x (cols + 1)
//    footprint cells it touches (warp_cells.cuh's band_tap).
//  * The dW1s kernel keeps the run-time instance's tile of 25 offsets x 4
//    channels; its threads blend each block value from the four taps in
//    device memory (through L1) in place of a staged copy of the cells.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "reduce_parts.cuh"
#include "warp_bwd_tiles.cuh"
#include "warp_cells.cuh"
#include "warp_common.cuh"

// tools/kernel_split.py builds timing variants, each leaving one part out of
// both kernels: 1 the products, 2 the footprint cells (the cell dots, the
// epilogue's cell loads for d_flow; the dW1s kernel's cell copies and
// blend), 3 the reductions into d_source; 0 (the kernels) leaves nothing.
#ifndef GFLA_SPLIT
#define GFLA_SPLIT 0
#endif
#ifndef GFLA_WARP_BF16
#define GFLA_WARP_BF16 0  // 1: the bf16 instances (warp_bwd_bf16.cu)
#endif

namespace {

constexpr bool kBf16 = GFLA_WARP_BF16;
// the source, g and W2: f32, or bf16 as bits
using SrcT = std::conditional_t<kBf16, uint16_t, float>;

// a value at a point where gfla_tpu's bf16 body rounds it
__device__ __forceinline__ float at_bf16(float x) {
  return kBf16 ? gfla::bf16_round(x) : x;
}

using gfla::kPosRows;
using gfla::kW1Chunk;
using gfla::kW1Units;
constexpr int kThreads = 256;  // dW1s kernel: 8 warps
constexpr int kRows = kPosRows;
constexpr int kPosThreads = 2 * kRows;  // a warp per 16 positions
constexpr int kDepth = 16;     // hidden units per W1s stage
constexpr int kLdw = kDepth + 4;  // = 4 mod 8: conflict-free fragment loads
constexpr int kStages = 3;     // W1s ring
constexpr int kChunk = kW1Chunk;
constexpr int kLdh = gfla::mma_col_stride(kW1Units);

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four channels from c of row `row` of an (rows x C) tensor, zero past C,
// as floats. kVec: C is a multiple of 4 and the tensor 16-byte aligned.
template <bool kVec, typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ base, int row,
                                        int c, int C) {
  const T* at = base + static_cast<size_t>(row) * C + c;
  if (kVec) {
    return c < C ? gfla::ldg4(at) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(c < C ? gfla::to_float(__ldg(at)) : 0.0f,
                     c + 1 < C ? gfla::to_float(__ldg(at + 1)) : 0.0f,
                     c + 2 < C ? gfla::to_float(__ldg(at + 2)) : 0.0f,
                     c + 3 < C ? gfla::to_float(__ldg(at + 3)) : 0.0f);
}

// base[row][c..c+3] += v, zero past C: one vector reduction when kVec.
template <bool kVec>
__device__ __forceinline__ void red4(float* base, int row, int c, int C,
                                     float4 v) {
  float* at = base + static_cast<size_t>(row) * C + c;
  if (GFLA_SPLIT == 3) return;
  if (kVec) {
    if (c >= C) return;
    // no memory clobber: nothing in these kernels reads d_source, and the
    // loads of the cells may then be issued ahead of the reductions
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(at),
                 "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));
  } else {
    if (c < C) atomicAdd(at, v.x);
    if (c + 1 < C) atomicAdd(at + 1, v.y);
    if (c + 2 < C) atomicAdd(at + 2, v.z);
    if (c + 3 < C) atomicAdd(at + 3, v.w);
  }
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 acc) {
  return make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y),
                     fmaf(w, v.z, acc.z), fmaf(w, v.w, acc.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// One split-f32 product step: d += a . b as lo.hi, hi.lo, hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  gfla::mma_tf32(d, a_lo, b_hi);
  gfla::mma_tf32(d, a_hi, b_lo);
  gfla::mma_tf32(d, a_hi, b_hi);
}

// ---- per-position kernel ----------------------------------------------------

// The product tile of a band holds R x K offsets of 8 channels (R K
// fragments of 8 columns, 4 accumulators each, a lane): warp_bwd_tiles.cuh.
// KT: the instance's k, or 0 for the run-time instance, whose tile is one
// offset row of up to kWarpMaxK offsets.
// KT < 0: the wide instance, whose bands are runs of up to kWideCols
// offsets of one row.
template <int KT>
struct PosShape {
  static constexpr int KM =  // its widest k, or a wide band's offsets
      KT > 0 ? KT : (KT == 0 ? gfla::kWarpMaxK : gfla::kWideCols);
  static constexpr int K1M = KM + 1;
  static constexpr int R = KT > 0 ? gfla::pos_band_rows(KT) : 1;
  static constexpr int NT = R * KM;
  static constexpr int RowsB = NT * 8;  // W1s rows of a stage
  static constexpr int Ring = kStages * RowsB * kLdw;
};

__host__ __device__ constexpr int pos_lda(int D) {
  return (D + kDepth - 1) / kDepth * kDepth + 4;  // = 4 mod 8
}

// Row stride of W2 (D x k^2) in shared memory: odd, so that a warp reading
// one of its columns meets no bank conflict; an even k^2 is padded by one.
__host__ __device__ constexpr int pos_ldw2(int k) { return k * k | 1; }

// Floats of the region that holds the W1s ring during the product and,
// before it, the cell dots, d_attn and W2.
template <int KT>
__host__ __device__ int pos_ring_floats(int k, int D) {
  if (KT < 0) return PosShape<KT>::Ring;  // the wide instance: the ring alone
  const int before =
      kRows * ((k + 1) * (k + 1) + k * k) + D * pos_ldw2(k);
  constexpr int kRing = PosShape<KT>::Ring;
  return (kRing > before ? kRing : before + 3) / 4 * 4;
}

template <int KT>
size_t pos_smem_bytes(int k, int D) {
  if (KT < 0) {  // d_hpre, the ring, and each position's footprint
    return sizeof(float) * (static_cast<size_t>(kRows) * pos_lda(D) +
                            pos_ring_floats<KT>(k, D)) +
           kRows * (sizeof(float2) + sizeof(gfla::Footprint) + sizeof(int));
  }
  return sizeof(float) * (static_cast<size_t>(kRows) * pos_lda(D) +
                          kRows * k * k + pos_ring_floats<KT>(k, D)) +
         kRows * (sizeof(float2) + 2 * (k + 1) * sizeof(int));
}

// Grid (position tiles, channel splits). Split y takes items
// [y * per_cta, (y + 1) * per_cta) of the n_items = Bands x ceil(C / 8)
// (band, channel group) pairs and writes d_flow partial y; split 0 also
// writes d_hpre and the dW2/db2 partial of its position tile. k_run: the
// block size, read by the run-time instance (KT = 0) only.
template <int KT, bool kVec>
__global__ void __launch_bounds__(kPosThreads, 2)
    warp_bwd_pos_kernel(const SrcT* __restrict__ src,
                        const float* __restrict__ flow,
                        const float* __restrict__ hpre,
                        const float* __restrict__ w1s,
                        const SrcT* __restrict__ w2,
                        const float* __restrict__ b2,
                        const SrcT* __restrict__ g, float* __restrict__ dsrc,
                        float* __restrict__ dflow_part,
                        float* __restrict__ dhbt, float* __restrict__ w2_part,
                        const float* __restrict__ attn_g, int N, int H,
                        int W, int C, int D, float slope, int n_items,
                        int per_cta, int k_run) {
  using S = PosShape<KT>;
  constexpr int NT = S::NT, K1M = S::K1M;
  constexpr bool kWide = KT < 0;
  const int K = KT > 0 ? KT : k_run;
  const int K1 = K + 1, K2 = K * K, KC = K1 * K1;
  const int ldw2 = pos_ldw2(K);
  const float inv_k2 = 1.0f / static_cast<float>(K2);
  const int lda = pos_lda(D);
  extern __shared__ __align__(16) float smem[];
  float* at = smem;                        // kRows x lda: hidden, then d_hpre
  float* att = at + kRows * lda;           // kRows x K2: softmax (wide: none,
  float* ring = att + (kWide ? 0 : kRows * K2);  // attn_g); W1s ring;
  float* cdot = ring;                      //   before it kRows x KC cell dots,
  float* dat = ring + kRows * KC;          //   kRows x K2 d_attn, d_logits
  float* w2s = dat + kRows * K2;           //   D x ldw2 W2 (none when wide)
  float2* wyx = reinterpret_cast<float2*>(ring + pos_ring_floats<KT>(K, D));
  int* rowoff = reinterpret_cast<int*>(wyx + kRows);  // kRows x K1: pixel of
  int* col = rowoff + kRows * K1;          // (row, 0) in the batch; column
  // wide: each position's footprint and batch element in place of the tables
  gfla::Footprint* fpw = reinterpret_cast<gfla::Footprint*>(wyx + kRows);
  int* bat = reinterpret_cast<int*>(fpw + kRows);
  // pixel of footprint row i, column 0 of position t; column of footprint
  // column j
  auto row_off = [&](int t, int i) -> int {
    if constexpr (kWide) {
      return (bat[t] * H + gfla::tap_row(fpw[t], i, H)) * W;
    } else {
      return rowoff[t * K1 + i];
    }
  };
  auto col_at = [&](int t, int j) -> int {
    if constexpr (kWide) {
      return gfla::tap_col(fpw[t], j, W);
    } else {
      return col[t * K1 + j];
    }
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = blockIdx.x * kRows;
  const int HW = H * W;
  const bool first = blockIdx.y == 0;

  for (int t = tid; t < kRows; t += kPosThreads) {
    const int p = p0 + t;
    if (p < N) {
      const int b = p / HW;
      const int rem = p - b * HW;
      const int y = rem / W;
      const int x = rem - y * W;
      const gfla::Footprint fp =
          gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, K);
      wyx[t] = make_float2(fp.wy, fp.wx);
      if constexpr (kWide) {
        fpw[t] = fp;
        bat[t] = b;
      } else {
        for (int i = 0; i < K1; ++i) {
          rowoff[t * K1 + i] = (b * H + gfla::tap_row(fp, i, H)) * W;
          col[t * K1 + i] = gfla::tap_col(fp, i, W);
        }
      }
    } else {  // past the end: weights 0 on pixel 0
      wyx[t] = make_float2(0.0f, 0.0f);
      if constexpr (kWide) {
        fpw[t] = gfla::Footprint{0, 0, 0.0f, 0.0f};
        bat[t] = 0;
      } else {
        for (int i = 0; i < K1; ++i) {
          rowoff[t * K1 + i] = 0;
          col[t * K1 + i] = 0;
        }
      }
    }
  }
  if constexpr (kWide) {
    // d_hpre from warp_bwd_wide_prep_kernel, zero past D and past N
    for (int e = tid; e < kRows * lda; e += kPosThreads) {
      const int t = e / lda;
      const int d = e - t * lda;
      const int p = p0 + t;
      at[e] = p < N && d < D ? dhbt[static_cast<size_t>(p) * D + d] : 0.0f;
    }
  } else {
    // W2 (D x K2, rows ldw2 apart: pos_ldw2)
    for (int e = tid; e < D * K2; e += kPosThreads) {
      const int d = e / K2;
      w2s[d * ldw2 + e - d * K2] = gfla::to_float(w2[e]);
    }
    // hidden = LeakyReLU(hpre), zero past D and past N
    for (int e = tid; e < kRows * lda; e += kPosThreads) {
      const int t = e / lda;
      const int d = e - t * lda;
      const int p = p0 + t;
      float h = 0.0f;
      if (p < N && d < D) {
        h = hpre[static_cast<size_t>(p) * D + d];
        h = h >= 0.0f ? h : h * slope;
      }
      at[e] = h;
    }
    __syncthreads();

    // ---- logits, softmax over the k^2 offsets (a warp per 16 positions) ----
    for (int e = tid; e < kRows * K2; e += kPosThreads) {
      const int t = e / K2;
      const int mm = e - t * K2;
      float s = 0.0f;
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(at_bf16(at[t * lda + dd]), w2s[dd * ldw2 + mm], s);
      }
      att[e] = s + b2[mm];
    }
    __syncthreads();
    for (int t = 16 * warp; t < 16 * warp + 16; ++t) {
      float* a = att + t * K2;
      constexpr int kVals = (S::KM * S::KM + 31) / 32;  // values a lane
      float v[kVals];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        v[u] = lane + 32 * u < K2 ? a[lane + 32 * u] : -INFINITY;
        mx = fmaxf(mx, v[u]);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        v[u] = lane + 32 * u < K2 ? expf(v[u] - mx) : 0.0f;
        sum += v[u];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int u = 0; u < kVals; ++u) {
        if (lane + 32 * u < K2) a[lane + 32 * u] = v[u] / sum;
      }
    }

    // ---- cell dots <src[cell], g>: 8 lanes a position, 4 channels a lane ----
    // A compiled instance takes all K1 footprint rows in one pass over the
    // channels, the run-time instance one row a pass.
    {
      constexpr int kPassRows = KT ? KT + 1 : 1;
      constexpr int kPassCells = kPassRows * K1M;
      const int sub = lane & 7;
      for (int t = tid >> 3; t < kRows; t += kPosThreads / 8) {
        const int p = p0 + t;
        for (int r0 = 0; r0 < K1; r0 += kPassRows) {
          float acc[kPassCells];
#pragma unroll
          for (int q = 0; q < kPassCells; ++q) acc[q] = 0.0f;
          if (p < N && GFLA_SPLIT != 2) {
            for (int c = 4 * sub; c < C; c += 32) {
              const float4 gv = load4<kVec>(g, p, c, C);
#pragma unroll
              for (int r = 0; r < kPassRows; ++r) {
                const int ro = rowoff[t * K1 + r0 + r];
#pragma unroll
                for (int s = 0; s < K1M; ++s) {
                  if (s < K1) {
                    acc[r * K1M + s] = dot4(
                        load4<kVec>(src, ro + col[t * K1 + s], c, C), gv,
                        acc[r * K1M + s]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kPassCells; ++q) {
            float v = acc[q];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            const int s = q % K1M;
            if (s < K1 && sub == (q & 7)) {
              cdot[t * KC + (r0 + q / K1M) * K1 + s] = v;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- d_attn from the cell dots; d_logits = attn (d_attn - <attn, d_attn>)
    for (int e = tid; e < kRows * K2; e += kPosThreads) {
      const int t = e / K2;
      const int m = e - t * K2;
      const int i = m / K;
      const float2 w = wyx[t];
      dat[e] = p0 + t < N
                   ? inv_k2 * gfla::cell_dattn(cdot + t * KC, K1,
                                               gfla::tap_weights(w.x, w.y), i,
                                               m - i * K)
                   : 0.0f;
    }
    __syncthreads();
    for (int t = tid; t < kRows; t += kPosThreads) {
      const float* a = att + t * K2;
      float* da = dat + t * K2;
      float s = 0.0f;
      for (int mm = 0; mm < K2; ++mm) s = fmaf(a[mm], da[mm], s);
      for (int mm = 0; mm < K2; ++mm) da[mm] = a[mm] * (da[mm] - s);
    }
    __syncthreads();

    // ---- this tile's dW2 = hidden^T d_logits and db2 = sum d_logits ---------
    if (first) {
      float* part = w2_part + static_cast<size_t>(blockIdx.x) * (D * K2 + K2);
      for (int e = tid; e < D * K2; e += kPosThreads) {
        const int d = e / K2;
        const int mm = e - d * K2;
        float s = 0.0f;
        for (int t = 0; t < kRows; ++t) {
          s = fmaf(at[t * lda + d], dat[t * K2 + mm], s);
        }
        part[e] = s;
      }
      for (int mm = tid; mm < K2; mm += kPosThreads) {
        float s = 0.0f;
        for (int t = 0; t < kRows; ++t) s += dat[t * K2 + mm];
        part[D * K2 + mm] = s;
      }
    }
    __syncthreads();  // hidden fully read before d_hpre overwrites it

    // ---- d_hpre = LeakyReLU'(hpre) (d_logits . W2^T): the product's A -------
    for (int e = tid; e < kRows * lda; e += kPosThreads) {
      const int t = e / lda;
      const int d = e - t * lda;
      const int p = p0 + t;
      float dh = 0.0f;
      if (p < N && d < D) {
        float s = 0.0f;
        for (int mm = 0; mm < K2; ++mm) {
          s = fmaf(at_bf16(dat[t * K2 + mm]), w2s[d * ldw2 + mm], s);
        }
        dh = at_bf16(hpre[static_cast<size_t>(p) * D + d] >= 0.0f ? s
                                                                   : s * slope);
        if (first) dhbt[static_cast<size_t>(p) * D + d] = dh;
      }
      at[e] = dh;
    }
  }

  // ---- d_block = d_hpre . W1s^T per (band, channel group), on the tensor
  // cores; chunk q of the walk is item q / n_dchunks, hidden units
  // 16 (q % n_dchunks) ..
  const int n_groups = (C + 7) / 8;
  const int n_dchunks = (D + kDepth - 1) / kDepth;
  const int item0 = blockIdx.y * per_cta;
  const int my_items = max(0, min(per_cta, n_items - item0));
  const int n_chunks = my_items * n_dchunks;

  // W1s rows of chunk q into a ring stage: stage row n is the W1s row of
  // column n of the item's tile (gfla::pos_column, or wide_column); zero
  // past the band, C and D.
  // One commit per call, empty past the end.
  auto copy_b = [&](int q, float* stage) {
    if (q < n_chunks) {
      const int item = item0 + q / n_dchunks;
      const int d0 = (q % n_dchunks) * kDepth;
      const int band = item / n_groups;
      const int group = item - band * n_groups;
      const int nt_live = kWide ? gfla::wide_band(K, band).cols
                                : gfla::pos_band_fragments(K, band);
      constexpr int kPer = kVec ? 4 : 1;
      constexpr int kAcross = kDepth / kPer;
      for (int idx = tid; idx < S::RowsB * kAcross; idx += kPosThreads) {
        const int row = idx / kAcross;
        const int d = d0 + kPer * (idx - row * kAcross);
        const gfla::OffsetChannel mc =
            kWide ? gfla::wide_column(K, band, group, row)
                  : gfla::pos_column(K, band, group, row);
        const bool ok = (row >> 3) < nt_live && mc.c < C && d < D;
        const float* from =
            ok ? w1s + static_cast<size_t>(mc.m * C + mc.c) * D + d : w1s;
        float* to = stage + row * kLdw + (d - d0);
        if (kVec) {
          gfla::cp_async16(to, from, ok);
        } else {
          gfla::cp_async4(to, from, ok);
        }
      }
    }
    gfla::cp_async_commit();
  };

  __syncthreads();  // d_logits fully read: the ring is free
  for (int q = 0; q < kStages - 1; ++q) copy_b(q, ring + q * S::RowsB * kLdw);
  gfla::cp_async_wait<kStages - 2>();
  __syncthreads();  // d_hpre and the first stage are in

  // this lane's first fragment elements
  const int a_at = (16 * warp + gfla::mma_a_row(lane, 0)) * lda +
                   gfla::mma_a_depth(lane, 0);
  const int b_at = gfla::mma_b_col(lane) * kLdw + gfla::mma_b_depth(lane, 0);
  // after the trade: this lane's row and first channel of the group
  const int t_mine = 16 * warp + gfla::traded_row(lane);
  const int p_mine = p0 + t_mine;
  const bool live = p_mine < N;
  const int cq = gfla::traded_col(lane);
  float sy = 0.0f;
  float sx = 0.0f;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
  }
  // fragments of a band that hold an offset (all of them in a compiled
  // instance; K of the run-time instance's kWarpMaxK)
  const int nt_live = KT ? NT : K;
  int stage = 0;
  for (int q = 0; q < n_chunks; ++q) {
    {
      int to = stage + kStages - 1;
      if (to >= kStages) to -= kStages;
      copy_b(q + kStages - 1, ring + to * S::RowsB * kLdw);
    }
    const int dc = q % n_dchunks;
    const float* a_st = at + a_at + dc * kDepth;
    const float* b_st = ring + stage * S::RowsB * kLdw + b_at;
    if (GFLA_SPLIT == 1) {
      acc[0][0] += a_st[0] + b_st[0];
    } else if (kBf16) {
      // the stage's 16 hidden units in one step (mma_bf16.cuh's maps), from
      // depth 0 of this lane's A row and B column
      const float* a16 = a_st - gfla::mma_a_depth(lane, 0);
      const float* b16 = b_st - gfla::mma_b_depth(lane, 0);
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(
            a16 + 8 * (r & 1) * lda + gfla::mma16_a_depth(lane, r, 0));
        a[r] = gfla::pack_bf16x2(v.x, v.y);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= nt_live) break;
        uint32_t b[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              b16 + 8 * nt * kLdw + gfla::mma16_b_depth(lane, r, 0));
          b[r] = gfla::pack_bf16x2(v.x, v.y);
        }
        gfla::mma_bf16(acc[nt], a, b);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) {
        uint32_t a_hi[4], a_lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gfla::tf32_split_bits(
              a_st[8 * (e & 1) * lda + 8 * kk + 4 * (e >> 1)], a_hi[e],
              a_lo[e]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nt_live) break;
          uint32_t b_hi[2], b_lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            gfla::tf32_split_bits(b_st[8 * nt * kLdw + 8 * kk + 4 * e],
                                  b_hi[e], b_lo[e]);
          }
          mma3(acc[nt], a_hi, a_lo, b_hi, b_lo);
        }
      }
    }

    if (dc == n_dchunks - 1) {
      // ---- epilogue of one (band, channel group) ----
      const int item = item0 + q / n_dchunks;
      const int band = item / n_groups;
      const int c = (item - band * n_groups) * 8 + cq;
      // the band's first offset row and column, and its offsets a row (a
      // run of one row when wide)
      const gfla::WideBand wb = kWide ? gfla::wide_band(K, band)
                                      : gfla::WideBand{band * S::R, 0, K};
      const int i0 = wb.i;
      const int j0 = wb.j0;
      const int bcols = wb.cols;
      const int rows = min(S::R, K - i0);
      // trade with lane ^ 1: one row and four channels a lane
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float s0, s1;
        gfla::trade_out(lane, acc[nt], s0, s1);
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        gfla::trade_in(lane, acc[nt], r0, r1);
      }
      // + (1/k^2) attn g
      const float4 gv = live ? load4<kVec>(g, p_mine, c, C)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float* a_row =
          kWide ? attn_g + static_cast<size_t>(live ? p_mine : 0) * K2 +
                      i0 * K + j0
                : att + t_mine * K2 + i0 * K;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < rows * bcols) {
          const float w = inv_k2 * a_row[nt];
          acc[nt][0] = at_bf16(fmaf(w, gv.x, acc[nt][0]));
          acc[nt][1] = at_bf16(fmaf(w, gv.y, acc[nt][1]));
          acc[nt][2] = at_bf16(fmaf(w, gv.z, acc[nt][2]));
          acc[nt][3] = at_bf16(fmaf(w, gv.w, acc[nt][3]));
        }
      }
      // each footprint cell of the band: the blend-weighted sum of the
      // d_block vectors that use it as a tap goes into d_source; the same
      // sums with the weights' derivatives, against the cell's source
      // values, into d_flow. Two passes, so that the cell loads of the
      // first do not wait on one another.
      const float2 wv = wyx[t_mine];
      gfla::TapCoef coef[4];
#pragma unroll
      for (int role = 0; role < 4; ++role) {
        coef[role] = gfla::tap_coef(role, wv.x, wv.y);
      }
      // the d_block vector of the offset that holds cell (r, s) as `role`,
      // 0 where no offset of the band does. r, s and role are unrolled
      // counters, so the fragment index is known when compiling (clamped
      // into the array where the tap is not valid and never read).
      auto tap_of = [&](int role, int r, int s) {
        if (!gfla::role_valid(role, r, s, rows, bcols)) {
          return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        const int nt =
            gfla::role_row(role, r) * S::KM + gfla::role_col(role, s);
        const float* v = acc[nt < 0 ? 0 : (nt < NT ? nt : NT - 1)];
        return make_float4(v[0], v[1], v[2], v[3]);
      };
      if (live && GFLA_SPLIT != 2) {
#pragma unroll
        for (int r = 0; r <= S::R; ++r) {
          if (r > rows) continue;
          const int ro = row_off(t_mine, i0 + r);
#pragma unroll
          for (int s = 0; s < K1M; ++s) {
            if (s > bcols) break;
            const float4 sv =
                load4<kVec>(src, ro + col_at(t_mine, j0 + s), c, C);
            float4 vy = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            float4 vx = vy;
#pragma unroll
            for (int role = 0; role < 4; ++role) {
              const float4 v = tap_of(role, r, s);
              vy = fma4(coef[role].y, v, vy);
              vx = fma4(coef[role].x, v, vx);
            }
            sy = dot4(sv, vy, sy);
            sx = dot4(sv, vx, sx);
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r <= S::R; ++r) {
          if (r > rows) continue;
          const int ro = row_off(t_mine, i0 + r);
#pragma unroll
          for (int s = 0; s < K1M; ++s) {
            if (s > bcols) break;
            float4 vd = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int role = 0; role < 4; ++role) {
              vd = fma4(coef[role].d, tap_of(role, r, s), vd);
            }
            red4<kVec>(dsrc, ro + col_at(t_mine, j0 + s), c, C, vd);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      }
    }
    gfla::cp_async_wait<kStages - 2>();  // the next chunk of W1s is in
    __syncthreads();
    if (++stage == kStages) stage = 0;
  }
  gfla::cp_async_wait<0>();  // only empty groups are left

  // lanes q and q ^ 2 hold the same row
  sy += __shfl_xor_sync(0xffffffffu, sy, 2);
  sx += __shfl_xor_sync(0xffffffffu, sx, 2);
  if ((lane & 2) == 0 && live) {
    float* to = dflow_part + (static_cast<size_t>(blockIdx.y) * N + p_mine) * 2;
    to[0] = sx;  // (x, y) order, as the flow
    to[1] = sy;
  }
}

// ---- wide per-position backward, first part ---------------------------------

// Shared memory of warp_bwd_wide_prep_kernel: the hidden layer and each
// position's footprint.
size_t prep_smem_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(kRows) * pos_lda(D) +
         kRows * (sizeof(gfla::Footprint) + sizeof(int));
}

// For k above kWarpMaxK, per tile of kRows positions, what the first half of
// warp_bwd_pos_kernel computes, with the rows sized by k in device memory:
// the softmax into attn (N x k^2, which the wide product's epilogue reads),
// the cell dots <src[cell], g> into cdot (N x (k+1)^2) and d_logits into dl
// (N x k^2), this tile's dW2/db2 partial into w2_part, and d_hpre into dhbt
// (the wide product's A). A warp per position, in strides of 32 offsets or
// 4 channels a lane, where a position's rows are walked.
template <bool kVec>
__global__ void __launch_bounds__(kPosThreads)
    warp_bwd_wide_prep_kernel(const SrcT* __restrict__ src,
                              const float* __restrict__ flow,
                              const float* __restrict__ hpre,
                              const SrcT* __restrict__ w2,
                              const float* __restrict__ b2,
                              const SrcT* __restrict__ g,
                              float* __restrict__ dhbt,
                              float* __restrict__ w2_part,
                              float* __restrict__ attn,
                              float* __restrict__ dl,
                              float* __restrict__ cdot, int N, int H, int W,
                              int C, int D, int K, float slope) {
  constexpr int kWarps = kPosThreads / 32;
  const int K1 = K + 1, K2 = K * K, KC = K1 * K1;
  const float inv_k2 = 1.0f / static_cast<float>(K2);
  const int lda = pos_lda(D);
  extern __shared__ __align__(16) float smem[];
  float* hid = smem;  // kRows x lda: LeakyReLU(hpre), zero past D and N
  gfla::Footprint* fpw =
      reinterpret_cast<gfla::Footprint*>(hid + kRows * lda);
  int* bat = reinterpret_cast<int*>(fpw + kRows);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = blockIdx.x * kRows;
  const int HW = H * W;
  const int n_live = min(kRows, N - p0);

  for (int t = tid; t < n_live; t += kPosThreads) {
    const int p = p0 + t;
    const int b = p / HW;
    const int rem = p - b * HW;
    const int y = rem / W;
    const int x = rem - y * W;
    fpw[t] = gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, K);
    bat[t] = b;
  }
  for (int e = tid; e < kRows * lda; e += kPosThreads) {
    const int t = e / lda;
    const int d = e - t * lda;
    float h = 0.0f;
    if (t < n_live && d < D) {
      h = hpre[static_cast<size_t>(p0 + t) * D + d];
      h = h >= 0.0f ? h : h * slope;
    }
    hid[e] = h;
  }
  __syncthreads();

  // logits, then the softmax over the k^2 offsets
  for (int e = tid; e < n_live * K2; e += kPosThreads) {
    const int t = e / K2;
    const int mm = e - t * K2;
    float s = 0.0f;
    for (int dd = 0; dd < D; ++dd) {
      s = fmaf(at_bf16(hid[t * lda + dd]), gfla::to_float(w2[dd * K2 + mm]),
               s);
    }
    attn[static_cast<size_t>(p0 + t) * K2 + mm] = s + b2[mm];
  }
  __syncthreads();
  for (int t = warp; t < n_live; t += kWarps) {
    float* a = attn + static_cast<size_t>(p0 + t) * K2;
    float mx = -INFINITY;
    for (int m = lane; m < K2; m += 32) mx = fmaxf(mx, a[m]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int m = lane; m < K2; m += 32) sum += expf(a[m] - mx);
    sum = warp_sum(sum);
    for (int m = lane; m < K2; m += 32) a[m] = expf(a[m] - mx) / sum;
  }

  // cell dots <src[cell], g>
  for (int t = warp; t < n_live; t += kWarps) {
    const int p = p0 + t;
    float* cd = cdot + static_cast<size_t>(p) * KC;
    for (int cell = 0; cell < KC; ++cell) {
      const int r = cell / K1;
      const int pix = gfla::cell_pixel(fpw[t], bat[t], r, cell - r * K1, H, W);
      float acc = 0.0f;
      if (GFLA_SPLIT != 2) {
        for (int c = 4 * lane; c < C; c += 4 * 32) {
          acc = dot4(load4<kVec>(src, pix, c, C), load4<kVec>(g, p, c, C),
                     acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) cd[cell] = acc;
    }
  }
  __syncthreads();  // the softmax and cell dots in for every thread

  // d_attn from the cell dots; d_logits = attn (d_attn - <attn, d_attn>)
  for (int t = warp; t < n_live; t += kWarps) {
    const size_t p = p0 + t;
    const float* a = attn + p * K2;
    const float* cd = cdot + p * KC;
    float* da = dl + p * K2;
    const gfla::TapWeights w = gfla::tap_weights(fpw[t].wy, fpw[t].wx);
    float s = 0.0f;
    for (int m = lane; m < K2; m += 32) {
      const int i = m / K;
      const float v = inv_k2 * gfla::cell_dattn(cd, K1, w, i, m - i * K);
      da[m] = v;
      s = fmaf(a[m], v, s);
    }
    s = warp_sum(s);
    for (int m = lane; m < K2; m += 32) da[m] = a[m] * (da[m] - s);
  }
  __syncthreads();

  // this tile's dW2 = hidden^T d_logits and db2 = sum d_logits
  float* part = w2_part + static_cast<size_t>(blockIdx.x) * (D * K2 + K2);
  const float* dl0 = dl + static_cast<size_t>(p0) * K2;
  for (int e = tid; e < D * K2; e += kPosThreads) {
    const int d = e / K2;
    const int mm = e - d * K2;
    float s = 0.0f;
    for (int t = 0; t < n_live; ++t) {
      s = fmaf(hid[t * lda + d], dl0[t * K2 + mm], s);
    }
    part[e] = s;
  }
  for (int mm = tid; mm < K2; mm += kPosThreads) {
    float s = 0.0f;
    for (int t = 0; t < n_live; ++t) s += dl0[t * K2 + mm];
    part[D * K2 + mm] = s;
  }

  // d_hpre = LeakyReLU'(hpre) (d_logits . W2^T)
  for (int e = tid; e < n_live * D; e += kPosThreads) {
    const int t = e / D;
    const int d = e - t * D;
    const size_t p = p0 + t;
    float s = 0.0f;
    for (int mm = 0; mm < K2; ++mm) {
      s = fmaf(at_bf16(dl0[t * K2 + mm]), gfla::to_float(w2[d * K2 + mm]), s);
    }
    dhbt[p * D + d] = at_bf16(hpre[p * D + d] >= 0.0f ? s : s * slope);
  }
}

// ---- dW1s kernel ------------------------------------------------------------

// A CTA's columns: MT offsets x CW channels, offset-major, in NT fragments
// (warp_bwd_tiles.cuh); the run-time instance (KT = 0) holds the widest
// tile, kW1MaxFragments, and uses w1_fragments(k) of it, as the wide one
// (KT < 0) does.
template <int KT>
struct W1Shape {
  static constexpr int NT =
      KT > 0 ? gfla::w1_fragments(KT) : gfla::kW1MaxFragments;
  static constexpr int Ldb = gfla::mma_col_stride(NT * 8);
};

// floats of a cells stage, and ints and floats of a footprint
__host__ __device__ constexpr int w1_cells(int k) {
  return kChunk * (k + 1) * (k + 1) * gfla::w1_channels(k);
}
__host__ __device__ constexpr int w1_fp(int k) { return 2 * (k + 1) + 2; }
// the wide instance stages no cells; its footprint: batch element, first
// row and column, wy and wx bits
constexpr int kWideFp = 5;

template <int KT>
size_t w1_smem_bytes(int k) {
  const int cells = KT < 0 ? 0 : w1_cells(k);
  const int fp = KT < 0 ? kWideFp : w1_fp(k);
  return sizeof(float) * (2 * kChunk * 2 + 2 * cells + 2 * kChunk * kLdh +
                          2 * kChunk * W1Shape<KT>::Ldb + 3 * kChunk * fp);
}

// Grid (offset tiles x channel tiles, hidden-unit tiles, position ranges).
// CTA (x, y, z) writes part[z][m * C + c][d] = sum over its positions p of
// block_p[m][c] d_hpre_p[d], for its offsets m, channels c and units d.
// k_run: the block size, read by the run-time and wide instances (KT <= 0)
// only.
template <int KT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    warp_bwd_w1_kernel(const SrcT* __restrict__ src,
                       const float* __restrict__ flow,
                       const float* __restrict__ dhpre,
                       float* __restrict__ part, int N, int H, int W, int C,
                       int D, int n_ctiles, int span, int k_run) {
  using S = W1Shape<KT>;
  constexpr int NT = S::NT;
  constexpr bool kWide = KT < 0;
  const int K = KT > 0 ? KT : k_run;
  const int K1 = K + 1, K2 = K * K, KC = K1 * K1;
  const int CW = gfla::w1_channels(K), MT = gfla::w1_offsets(K);
  const int n_cells = kWide ? 0 : w1_cells(K);
  const int Fp = kWide ? kWideFp : w1_fp(K);
  const int nt_live = KT > 0 ? NT : gfla::w1_fragments(K);
  extern __shared__ __align__(16) float smem[];
  float* flow_st = smem;                      // 2 x kChunk x 2
  // 2 x kChunk x KC x CW source values (in the room of as many floats)
  SrcT* cells = reinterpret_cast<SrcT*>(flow_st + 2 * kChunk * 2);
  float* dh = flow_st + 2 * kChunk * 2 + 2 * n_cells;  // 2 x kChunk x kLdh
  float* bt = dh + 2 * kChunk * kLdh;         // kChunk x Ldb blocks, TF32
  //                                             hi parts, then lo parts
  int* fp = reinterpret_cast<int*>(bt + 2 * kChunk * S::Ldb);
  // 3 x kChunk footprints of Fp ints: rowoff[K1], col[K1], wy and wx bits
  // (wide: batch element, first row and column, wy and wx bits)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int HW = H * W;
  const int otile = blockIdx.x / n_ctiles;
  const int m0 = otile * MT;
  const int mt_here = min(MT, K2 - m0);
  const int ctile = blockIdx.x - otile * n_ctiles;
  const int c0 = ctile * CW;
  const int u0 = blockIdx.y * kW1Units;
  const int pbeg = blockIdx.z * span;
  const int pend = min(N, pbeg + span);
  const int nq = (pend - pbeg + kChunk - 1) / kChunk;

  // columns this tile never writes stay 0
  for (int e = tid; e < 2 * kChunk * S::Ldb; e += kThreads) bt[e] = 0.0f;

  auto copy_flow = [&](int q) {  // one float a thread
    if (tid < 2 * kChunk) {
      const int p = pbeg + q * kChunk + (tid >> 1);
      gfla::cp_async4(flow_st + (q & 1) * kChunk * 2 + tid,
                      p < pend ? flow + 2 * static_cast<size_t>(p) + (tid & 1)
                               : flow,
                      p < pend);
    }
  };
  // footprints of chunk q from its flow
  auto make_fp = [&](int q) {
    if (tid < kChunk) {
      const int p = pbeg + q * kChunk + tid;
      int* f = fp + ((q % 3) * kChunk + tid) * Fp;
      const float* fl = flow_st + (q & 1) * kChunk * 2 + 2 * tid;
      if (p < pend) {
        const int b = p / HW;
        const int rem = p - b * HW;
        const int y = rem / W;
        const int x = rem - y * W;
        const gfla::Footprint ft = gfla::footprint(fl[0], fl[1], y, x, H, W, K);
        if constexpr (kWide) {
          f[0] = b;
          f[1] = ft.y0;
          f[2] = ft.x0;
          f[3] = __float_as_int(ft.wy);
          f[4] = __float_as_int(ft.wx);
        } else {
          for (int i = 0; i < K1; ++i) {
            f[i] = (b * H + gfla::tap_row(ft, i, H)) * W;
            f[K1 + i] = gfla::tap_col(ft, i, W);
          }
          f[2 * K1] = __float_as_int(ft.wy);
          f[2 * K1 + 1] = __float_as_int(ft.wx);
        }
      } else {
        for (int i = 0; i < Fp; ++i) f[i] = 0;
      }
    }
  };
  // the footprint cells (CW channels; none when wide) and d_hpre rows of
  // chunk q
  auto copy_tiles = [&](int q) {
    SrcT* cst = cells + (q & 1) * n_cells;
    if (!kWide && GFLA_SPLIT != 2) {
      const int kQuads = CW / 4;
      for (int idx = tid; idx < kChunk * KC * kQuads; idx += kThreads) {
        const int t = idx / (KC * kQuads);
        const int rest = idx - t * KC * kQuads;
        const int cell = rest / kQuads;
        const int c = c0 + 4 * (rest - cell * kQuads);
        const int r = cell / K1;
        const int* f = fp + ((q % 3) * kChunk + t) * Fp;
        const bool in = pbeg + q * kChunk + t < pend;
        const size_t pix = static_cast<size_t>(f[r] + f[K1 + cell - r * K1]);
        SrcT* to = cst + (t * KC + cell) * CW + (c - c0);
        if (kVec) {
          const bool ok = in && c < C;
          if (kBf16) {
            gfla::cp_async8(to, ok ? src + pix * C + c : src, ok);
          } else {
            gfla::cp_async16(to, ok ? src + pix * C + c : src, ok);
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool ok = in && c + u < C;
            if (kBf16) {  // 2 bytes: no cp.async that small, a plain copy
              to[u] = ok ? src[pix * C + c + u] : SrcT{0};
            } else {
              gfla::cp_async4(to + u, ok ? src + pix * C + c + u : src, ok);
            }
          }
        }
      }
    }
    float* dst = dh + (q & 1) * kChunk * kLdh;
    constexpr int kPer = kVec ? 4 : 1;
    constexpr int kAcross = kW1Units / kPer;
    for (int idx = tid; idx < kChunk * kAcross; idx += kThreads) {
      const int t = idx / kAcross;
      const int u = kPer * (idx - t * kAcross);
      const int p = pbeg + q * kChunk + t;
      const bool ok = p < pend && u0 + u < D;
      const float* from = ok ? dhpre + static_cast<size_t>(p) * D + u0 + u
                             : dhpre;
      if (kVec) {
        gfla::cp_async16(dst + t * kLdh + u, from, ok);
      } else {
        gfla::cp_async4(dst + t * kLdh + u, from, ok);
      }
    }
  };

  copy_flow(0);
  if (nq > 1) copy_flow(1);
  gfla::cp_async_commit();
  gfla::cp_async_wait<0>();
  __syncthreads();
  make_fp(0);
  if (nq > 1) make_fp(1);
  __syncthreads();
  copy_tiles(0);
  if (nq > 2) copy_flow(2);
  gfla::cp_async_commit();

  // this warp's 16 hidden units; warps past D do no products
  const bool busy = u0 + 16 * warp < D;
  const int a_at = (gfla::mma_a_depth(lane, 0)) * kLdh + 16 * warp +
                   gfla::mma_a_row(lane, 0);
  const int b_at = gfla::mma_b_depth(lane, 0) * S::Ldb + gfla::mma_b_col(lane);
  float sum[NT][4];
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nt][e] = 0.0f;
  }

  for (int q = 0; q < nq; ++q) {
    gfla::cp_async_wait<0>();
    __syncthreads();  // chunk q's tiles and flow q + 2 are in; fp q + 1 made
    if (q + 2 < nq) make_fp(q + 2);
    if (q + 1 < nq) copy_tiles(q + 1);
    if (q + 3 < nq) copy_flow(q + 3);
    gfla::cp_async_commit();

    // blend: block[t][mo * CW + c] from the four cells of offset m0 + mo
    // (wide: from its four taps in device memory)
    if (GFLA_SPLIT != 2) {
      const SrcT* cst = cells + (q & 1) * n_cells;
      const int kQuads = CW / 4;
      for (int idx = tid; idx < kChunk * MT * kQuads; idx += kThreads) {
        const int t = idx / (MT * kQuads);
        const int rest = idx - t * MT * kQuads;
        const int mo = rest / kQuads;
        if (mo >= mt_here) continue;
        const int cw = 4 * (rest - mo * kQuads);
        const int m = m0 + mo;
        const int i = m / K;
        const int j = m - i * K;
        const int* f = fp + ((q % 3) * kChunk + t) * Fp;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if constexpr (kWide) {
          if (pbeg + q * kChunk + t < pend) {
            const gfla::Footprint ft{f[1], f[2], __int_as_float(f[3]),
                                     __int_as_float(f[4])};
            const gfla::TapWeights w = gfla::tap_weights(ft.wy, ft.wx);
            const int c = c0 + cw;
            auto tap = [&](int r, int s) {
              return load4<kVec>(
                  src, gfla::cell_pixel(ft, f[0], i + r, j + s, H, W), c, C);
            };
            v = fma4(w.tl, tap(0, 0), v);
            v = fma4(w.tr, tap(0, 1), v);
            v = fma4(w.bl, tap(1, 0), v);
            v = fma4(w.br, tap(1, 1), v);
          }
        } else {
          const gfla::TapWeights w = gfla::tap_weights(
              __int_as_float(f[2 * K1]), __int_as_float(f[2 * K1 + 1]));
          const SrcT* c00 = cst + (t * KC + i * K1 + j) * CW + cw;
          v = fma4(w.tl, gfla::lds4(c00), v);
          v = fma4(w.tr, gfla::lds4(c00 + CW), v);
          v = fma4(w.bl, gfla::lds4(c00 + K1 * CW), v);
          v = fma4(w.br, gfla::lds4(c00 + (K1 + 1) * CW), v);
        }
        float* at_hi = bt + t * S::Ldb + mo * CW + cw;
        if (kBf16) {  // the block rounded to bf16; no lo part
          *reinterpret_cast<float4*>(at_hi) =
              make_float4(at_bf16(v.x), at_bf16(v.y), at_bf16(v.z),
                          at_bf16(v.w));
          continue;
        }
        const gfla::Tf32Pair x = gfla::tf32_split(v.x);
        const gfla::Tf32Pair y = gfla::tf32_split(v.y);
        const gfla::Tf32Pair z = gfla::tf32_split(v.z);
        const gfla::Tf32Pair u = gfla::tf32_split(v.w);
        *reinterpret_cast<float4*>(at_hi) = make_float4(x.hi, y.hi, z.hi, u.hi);
        *reinterpret_cast<float4*>(at_hi + kChunk * S::Ldb) =
            make_float4(x.lo, y.lo, z.lo, u.lo);
      }
    }
    __syncthreads();

    if (busy) {
      const float* a_st = dh + (q & 1) * kChunk * kLdh + a_at;
      const float* b_st = bt + b_at;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
      }
      if (GFLA_SPLIT == 1) {
        acc[0][0] += a_st[0] + b_st[0];
      } else if (kBf16) {
        // 16 positions a step (mma_bf16.cuh's maps): A is d_hpre^T (rows
        // the units, depth the positions), B the blocks; from depth 0 of
        // this lane's A row and B column
        const float* a16 = a_st - gfla::mma_a_depth(lane, 0) * kLdh;
        const float* b16 = b_st - gfla::mma_b_depth(lane, 0) * S::Ldb;
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* at_a =
                a16 + (16 * kk + gfla::mma16_a_depth(lane, r, 0)) * kLdh +
                8 * (r & 1);
            a[r] = gfla::pack_bf16x2(at_a[0], at_a[kLdh]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nt_live) break;
            uint32_t b[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float* at_b =
                  b16 + (16 * kk + gfla::mma16_b_depth(lane, r, 0)) * S::Ldb +
                  8 * nt;
              b[r] = gfla::pack_bf16x2(at_b[0], at_b[S::Ldb]);
            }
            gfla::mma_bf16(acc[nt], a, b);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kChunk / 8; ++kk) {
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // row 8 (e & 1), depth 4 (e >> 1)
            gfla::tf32_split_bits(
                a_st[(8 * kk + 4 * (e >> 1)) * kLdh + 8 * (e & 1)], a_hi[e],
                a_lo[e]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt >= nt_live) break;
            uint32_t b_hi[2], b_lo[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float* at_b = b_st + (8 * kk + 4 * e) * S::Ldb + 8 * nt;
              b_hi[e] = gfla::f32_bits(at_b[0]);
              b_lo[e] = gfla::f32_bits(at_b[kChunk * S::Ldb]);
            }
            mma3(acc[nt], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[nt][e] += acc[nt][e];
      }
    }
  }
  gfla::cp_async_wait<0>();

  if (busy) {
    float* out = part + static_cast<size_t>(blockIdx.z) * K2 * C * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = u0 + 16 * warp + gfla::mma_c_row(lane, e);
        const gfla::OffsetChannel mc = gfla::w1_column(
            K, otile, ctile, 8 * nt + gfla::mma_c_col(lane, e));
        if (mc.m < m0 + mt_here && mc.c < C && u < D) {
          out[(static_cast<size_t>(mc.m) * C + mc.c) * D + u] = sum[nt][e];
        }
      }
    }
  }
}

template <int KT, bool kVec>
int launch_pos(const SrcT* src, const float* flow, const float* hpre,
               const float* w1s, const SrcT* w2, const float* b2,
               const SrcT* g, float* dsrc, float* dflow, float* dhbt,
               float* scratch, float* dw2b2, int N, int H, int W, int C,
               int D, int K, float slope, cudaStream_t stream) {
  const int K2 = K * K;
  const gfla::PosPlan plan = gfla::pos_plan(N, C, K);
  const size_t smem = pos_smem_bytes<KT>(K, D);
  const cudaError_t err = cudaFuncSetAttribute(
      warp_bwd_pos_kernel<KT, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* w2_part = scratch;
  float* flow_part =
      scratch + static_cast<size_t>(plan.tiles) * (D * K2 + K2);
  // the wide instance's rows: softmax, d_logits (N x k^2), cell dots
  float* attn = flow_part + static_cast<size_t>(plan.splits) * N * 2;
  float* dl = attn + static_cast<size_t>(N) * K2;
  float* cdot = dl + static_cast<size_t>(N) * K2;
  int e = 0;
  if (KT < 0) {
    const size_t prep_smem = prep_smem_bytes(D);
    e = static_cast<int>(cudaFuncSetAttribute(
        warp_bwd_wide_prep_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(prep_smem)));
    if (e != 0) return e;
    warp_bwd_wide_prep_kernel<kVec><<<plan.tiles, kPosThreads, prep_smem,
                                      stream>>>(
        src, flow, hpre, w2, b2, g, dhbt, w2_part, attn, dl, cdot, N, H, W, C,
        D, K, slope);
    e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
  }
  const dim3 grid(plan.tiles, plan.splits);
  warp_bwd_pos_kernel<KT, kVec><<<grid, kPosThreads, smem, stream>>>(
      src, flow, hpre, w1s, w2, b2, g, dsrc, flow_part, dhbt, w2_part,
      KT < 0 ? attn : nullptr, N, H, W, C, D, slope, plan.items,
      plan.per_cta, K);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  e = gfla::launch_reduce(w2_part, plan.tiles,
                          static_cast<size_t>(D) * K2 + K2, dw2b2, stream);
  if (e != 0) return e;
  return gfla::launch_reduce(flow_part, plan.splits,
                             static_cast<size_t>(N) * 2, dflow, stream);
}

template <int KT, bool kVec>
int launch_w1(const SrcT* src, const float* flow, const float* dhpre,
              float* part, float* dw1s, int N, int H, int W, int C, int D,
              int K, cudaStream_t stream) {
  const int K2 = K * K;
  const gfla::W1Plan plan = gfla::w1_plan(N, C, D, K);
  const size_t smem = w1_smem_bytes<KT>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      warp_bwd_w1_kernel<KT, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(gfla::w1_offset_tiles(K) * plan.ctiles, plan.utiles,
                  plan.splits);
  warp_bwd_w1_kernel<KT, kVec><<<grid, kThreads, smem, stream>>>(
      src, flow, dhpre, part, N, H, W, C, D, plan.ctiles, plan.span, K);
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  return gfla::launch_reduce(part, plan.splits,
                             static_cast<size_t>(K2) * C * D, dw1s, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

#if GFLA_WARP_BF16
#define GFLA_WARP_BWD_POS gfla_warp_bwd_pos_bf16
#define GFLA_WARP_BWD_W1 gfla_warp_bwd_w1_bf16
#define GFLA_WARP_BWD_POS_SCRATCH gfla_warp_bwd_pos_scratch_bf16
#define GFLA_WARP_BWD_W1_SCRATCH gfla_warp_bwd_w1_scratch_bf16
#else
#define GFLA_WARP_BWD_POS gfla_warp_bwd_pos
#define GFLA_WARP_BWD_W1 gfla_warp_bwd_w1
#define GFLA_WARP_BWD_POS_SCRATCH gfla_warp_bwd_pos_scratch
#define GFLA_WARP_BWD_W1_SCRATCH gfla_warp_bwd_w1_scratch
#endif

// Scratch sizes, in floats, that the wrapper allocates for the partial sums:
// the per-position kernel's dW2/db2 and d_flow partials (and above k = 9
// the wide instance's rows: softmax and d_logits, N x k^2 each, cell dots,
// N x (k+1)^2); the dW1s partials.
// The bf16 instances have the same plans (and their own copies, so that a
// library of either alone is whole).
extern "C" long long GFLA_WARP_BWD_POS_SCRATCH(int N, int C, int D, int k) {
  const gfla::PosPlan plan = gfla::pos_plan(N, C, k);
  const long long rows =
      gfla::warp_k_wide(k)
          ? static_cast<long long>(N) * (2 * k * k + (k + 1) * (k + 1))
          : 0;
  return static_cast<long long>(plan.tiles) * (D * k * k + k * k) +
         static_cast<long long>(plan.splits) * N * 2 + rows;
}

extern "C" long long GFLA_WARP_BWD_W1_SCRATCH(int N, int C, int D, int k) {
  return static_cast<long long>(gfla::w1_plan(N, C, D, k).splits) * k * k *
         C * D;
}

// Per-position backward. source (B,H,W,C), flow (B,H,W,2) as (x, y), hpre
// (B*H*W, D): the forward's pre-activation hidden layer, w1s (k*k*C, D), w2
// (D, k*k), b2 (k*k), g (B,H,W,C). Outputs: dsrc (B,H,W,C), zeroed by the
// caller (a reduction target); dflow (B,H,W,2) in (x, y) order; dhbt
// (B*H*W, D); dw2b2 (D*k*k + k*k): dW2 (D, k*k) followed by db2. scratch:
// gfla_warp_bwd_pos_scratch floats. Returns a cudaError_t; 0 means every
// launch was accepted. gfla_warp_bwd_pos_bf16: the same, with source, W2
// and g in bf16 (bits), W1s holding bf16 values in f32, and d_hidden_bt
// rounded to bf16.
extern "C" int GFLA_WARP_BWD_POS(const SrcT* src, const float* flow,
                                 const float* hpre, const float* w1s,
                                 const SrcT* w2, const float* b2,
                                 const SrcT* g, float* dsrc, float* dflow,
                                 float* dhbt, float* scratch, float* dw2b2,
                                 int B, int H, int W, int C, int D, int k,
                                 float slope, void* stream) {
  const int N = B * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && D % 4 == 0 && aligned16(src) &&
                   aligned16(g) && aligned16(dsrc) && aligned16(w1s);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
#define GFLA_POS(KT, V)                                                    \
  return launch_pos<KT, V>(src, flow, hpre, w1s, w2, b2, g, dsrc, dflow,   \
                           dhbt, scratch, dw2b2, N, H, W, C, D, k, slope, s)
#define GFLA_POS_K(KT)          \
  if (vec) GFLA_POS(KT, true);  \
  GFLA_POS(KT, false)
  if (gfla::warp_k_wide(k)) {  // every k above 9
    GFLA_POS_K(-1);
  }
  switch (k) {
    case 3: GFLA_POS_K(3);
    case 5: GFLA_POS_K(5);
    default: GFLA_POS_K(0);  // every other k, at run time
  }
#undef GFLA_POS_K
#undef GFLA_POS
}

// dW1s (k*k*C, D) from source, flow and d_hpre (B*H*W, D). part:
// gfla_warp_bwd_w1_scratch floats. Returns a cudaError_t.
// gfla_warp_bwd_w1_bf16: the same, with the source in bf16 (bits) and d_hpre
// holding bf16 values in f32 (the blocks are rounded to bf16 as they are
// blended).
extern "C" int GFLA_WARP_BWD_W1(const SrcT* src, const float* flow,
                                const float* dhpre, float* part, float* dw1s,
                                int B, int H, int W, int C, int D, int k,
                                void* stream) {
  const int N = B * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && D % 4 == 0 && aligned16(src) &&
                   aligned16(dhpre);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
#define GFLA_W1(KT, V) \
  return launch_w1<KT, V>(src, flow, dhpre, part, dw1s, N, H, W, C, D, k, s)
#define GFLA_W1_K(KT)          \
  if (vec) GFLA_W1(KT, true);  \
  GFLA_W1(KT, false)
  if (gfla::warp_k_wide(k)) {  // every k above 9
    GFLA_W1_K(-1);
  }
  switch (k) {
    case 3: GFLA_W1_K(3);
    case 5: GFLA_W1_K(5);
    default: GFLA_W1_K(0);  // every other k, at run time
  }
#undef GFLA_W1_K
#undef GFLA_W1
}
