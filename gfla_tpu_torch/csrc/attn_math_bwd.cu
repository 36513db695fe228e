// Local-attention math over gathered blocks, backward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_attn.py::_bwd_kernel (launched by
// _attn_math_bwd_pallas under the custom VJP attn_math_fused). Given the
// blocks bs (N, k^2, C), the forward's pre-activation hidden layer hpre
// (N, D), stored by attn_math_fwd.cu, so nothing is recomputed, and the
// output cotangent g (N, C), it writes
//     d_bs   = d_hpre . W1s^T + (1/k^2) attn g        (N, k^2, C)
//     d_bt   = d_hpre . W1t^T                         (N, k^2, C)
//     d_hpre = LeakyReLU'(hpre) (d_logits . W2^T)     (N, D)
// with d_logits = attn (d_attn - sum attn d_attn), d_attn = (1/k^2) <bs, g>,
// W1t and W1s the target and source halves of W1 (k^2, 2C, D), and the sums
// over positions dW2 = hidden^T d_logits, db1 = sum d_hpre, db2 = sum
// d_logits. dW1 = [bt || bs]^T d_hpre is one matrix product outside the
// kernels, as gfla_tpu computes it outside its kernel. Two kernels share the
// work:
//
//  * attn_bwd_rows_kernel, per position: hidden = LeakyReLU(hpre), logits,
//    softmax, d_attn (bs read once, 16 bytes a lane), d_logits, the CTA's
//    dW2, db2 and db1, and d_hpre, which it writes with the softmax for the
//    product kernel;
//  * attn_bwd_product_kernel: d_[bt || bs] = d_hpre . W1^T on the tensor
//    cores, and (1/k^2) attn g added into the source half.
//  * reduce_parts sums the partials in a fixed order, so dW2, db1 and db2
//    are deterministic; d_bs, d_bt and d_hpre are written once per element,
//    with no atomics.
//
// What bounds it on an H100: at the k=5 site (N = 8*64*64, k^2 = 25, C = 128,
// D = 128) the product is 2 * N * 6400 * 128 = 53.7 GFLOP, 0.33 ms at the
// 165 TFLOP/s of f32 work that split-f32 products (mma_tf32x3.cuh) get from
// the tensor cores; bs, g and hpre read once and d_bs, d_bt and d_hpre
// written once are 1.3 GB, 0.39 ms at 3.35 TB/s: bytes, nearly balanced with
// the operations.
//
// What the design does about it:
//  * per position: a CTA of 8 warps owns 32 positions (attn_math_steps.cuh's
//    softmax); 8 lanes take each (position, offset) dot <bs, g>, 4 channels
//    a lane, so the blocks are read once, coalesced. Its partial sums go to
//    scratch.
//  * product: both operands lie with the depth D innermost, as wgmma takes
//    TF32 operands (attn_math_steps.cuh): a CTA multiplies the d_hpre rows
//    of 128 positions by items of 128 columns, each a run of 128 channels of
//    one (offset, half) (attn_math_tiles.cuh), so an item's output rows are
//    contiguous; W1 is read once per 128 positions, 256 times at the k=5
//    site. When the position tiles leave SMs idle (the k=3 site) the items
//    are split over CTAs. mma.sync from fragments split at load took 1.6x
//    as long for this product on an H100 (PERF.md, section 6).
//
// bf16 (attn_math_bwd_bf16.cu builds this file with GFLA_ATTN_BF16 = 1,
// entry gfla_attn_math_bwd_bf16): gfla_tpu's _bwd_kernel with bf16 blocks
// and parameters. It reads bs, g, W1, W2 and b2 in bf16 and the f32 hpre,
// and writes d_bs, d_bt and d_hpre in bf16; dW2, db1 and db2 stay f32 sums
// in reduce_parts' fixed order. As gfla_tpu's body (pallas_attn.py:
// 155-228), it rounds the hidden layer to bf16 before W2 and for dW2 and
// d_hpre before the product and the store; the softmax, d_attn, d_logits,
// d_h and d_hpre are f32, and db1 is summed from the unrounded d_hpre. The
// product d_hpre . W1^T is bf16 mma.sync m16n8k16 (attn_math_bf16.cuh) over
// W1 as it lies, and (1/k^2) attn g is added in f32 before d_bs is rounded.
// Its bound is the bytes: the blocks read and their gradients written.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

// tools/kernel_split.py builds timing variants, each leaving one part out:
// 1 the product, 2 the tile copies and splits (W1 and d_hpre stages), 3 the
// product's epilogue (+ attn g, the stores of d_bs and d_bt), 4 the d_attn
// read of the blocks; 0 (the kernels) leaves nothing out.
#ifndef GFLA_SPLIT
#define GFLA_SPLIT 0
#endif

#ifndef GFLA_ATTN_BF16
#define GFLA_ATTN_BF16 0  // 1: the bf16 instance (attn_math_bwd_bf16.cu)
#endif

#include "attn_math_bf16.cuh"
#include "attn_math_steps.cuh"
#include "attn_math_tiles.cuh"
#include "reduce_parts.cuh"

namespace {

using gfla::kAttnRowPos;
using gfla::kAttnTile;
using gfla::kGemmThreads;

constexpr bool kBf16 = GFLA_ATTN_BF16;
// bs, g, the parameters and d_bs, d_bt, d_hpre: f32, or bf16 as bits
using ElemT = std::conditional_t<kBf16, uint16_t, float>;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// ---- per-position kernel ----------------------------------------------------

__host__ __device__ constexpr int rows_ld(int D) { return D + 1; }

size_t rows_smem_bytes(int k2, int D) {
  return sizeof(float) *
         (static_cast<size_t>(kAttnRowPos) * (rows_ld(D) + 2 * k2) + D * k2);
}

// CTA x: positions p0 = 32 x .. p0 + 31, of which the first n_valid exist.
// Writes d_hpre and att_out (N, k2), the softmax, for those rows, and its
// partial sums part[x] = dW2 (D x k2), db1 (D), db2 (k2).
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads)
    attn_bwd_rows_kernel(const ElemT* __restrict__ bs,
                         const float* __restrict__ hpre,
                         const ElemT* __restrict__ g,
                         const ElemT* __restrict__ w2,
                         const ElemT* __restrict__ b2,
                         ElemT* __restrict__ d_hpre,
                         float* __restrict__ att_out,
                         float* __restrict__ part, int N, int K2, int C,
                         int D, float slope) {
  constexpr int kRows = kAttnRowPos;
  const float inv_k2 = 1.0f / static_cast<float>(K2);
  const int ld = rows_ld(D);
  extern __shared__ __align__(16) float smem[];
  float* hid = smem;                  // kRows x ld: hidden
  float* att = hid + kRows * ld;      // kRows x K2: softmax
  float* dat = att + kRows * K2;      // kRows x K2: d_attn, then d_logits
  float* w2s = dat + kRows * K2;      // D x K2

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = blockIdx.x * kRows;
  const int n_valid = min(kRows, N - p0);

  // d_attn[t][m] = (1/k^2) <bs[p][m], g[p]>: 8 lanes a (position, offset),
  // the four groups of a warp on neighbouring pairs; every lane of a warp
  // takes the same number of turns, for the shuffles
  {
    const int sub = lane & 7;
    for (int base = 4 * warp; base < kRows * K2; base += kGemmThreads / 8) {
      const int e = base + (lane >> 3);
      const int t = e / K2;
      const int m = e - t * K2;
      float s = 0.0f;
      if (e < kRows * K2 && t < n_valid && GFLA_SPLIT != 4) {
        const size_t p = static_cast<size_t>(p0 + t);
        for (int c = 4 * sub; c < C; c += 32) {
          s = dot4(gfla::load4<kVec>(bs, p * K2 + m, c, C),
                   gfla::load4<kVec>(g, p, c, C), s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (sub == 0 && e < kRows * K2) dat[e] = s * inv_k2;
    }
  }
  auto hpre_row = [&](int t, int d) {
    return hpre[static_cast<size_t>(p0 + t) * D + d];
  };
  gfla::rows_softmax(hpre_row, n_valid, w2, b2, hid, ld, w2s, att, K2, D,
                     slope);

  // d_logits = attn (d_attn - <attn, d_attn>), 0 past n_valid; the softmax
  // to att_out (a warp per 4 positions)
  for (int t = warp * (kRows / 8); t < (warp + 1) * (kRows / 8); ++t) {
    const float* a = att + t * K2;
    float* da = dat + t * K2;
    float ad = 0.0f;
    for (int mm = lane; mm < K2; mm += 32) ad = fmaf(a[mm], da[mm], ad);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ad += __shfl_xor_sync(0xffffffffu, ad, o);
    for (int mm = lane; mm < K2; mm += 32) {
      da[mm] = t < n_valid ? a[mm] * (da[mm] - ad) : 0.0f;
      if (t < n_valid) {
        att_out[static_cast<size_t>(p0 + t) * K2 + mm] = a[mm];
      }
    }
  }
  __syncthreads();

  // ---- this CTA's dW2 = hidden^T d_logits, db2 = sum d_logits -------------
  float* my_part = part + static_cast<size_t>(blockIdx.x) * (D * K2 + D + K2);
  for (int e = tid; e < D * K2; e += kGemmThreads) {
    const int d = e / K2;
    const int mm = e - d * K2;
    float s = 0.0f;
#pragma unroll 8
    for (int t = 0; t < kRows; ++t) {
      s = fmaf(hid[t * ld + d], dat[t * K2 + mm], s);
    }
    my_part[e] = s;
  }
  for (int mm = tid; mm < K2; mm += kGemmThreads) {
    float s = 0.0f;
    for (int t = 0; t < kRows; ++t) s += dat[t * K2 + mm];
    my_part[D * K2 + D + mm] = s;
  }

  // ---- d_hpre = LeakyReLU'(hpre) (d_logits . W2^T), and db1 ----------------
  for (int d = tid; d < D; d += kGemmThreads) {
    const float* w2row = w2s + d * K2;
    float sum = 0.0f;
    for (int t = 0; t < n_valid; ++t) {
      float s = 0.0f;
      for (int mm = 0; mm < K2; ++mm) s = fmaf(dat[t * K2 + mm], w2row[mm], s);
      const size_t at = static_cast<size_t>(p0 + t) * D + d;
      const float dh = hpre[at] >= 0.0f ? s : s * slope;
      if constexpr (kBf16) {
        d_hpre[at] = gfla::bf16_bits(dh);
      } else {
        d_hpre[at] = dh;
      }
      sum += dh;
    }
    my_part[D * K2 + d] = sum;
  }
}

// ---- product kernel -----------------------------------------------------------

// Grid (position tiles, item splits). CTA (x, y) multiplies the d_hpre rows
// of positions 128 x .. by the W1 rows of items [y * per_cta, min(items,
// (y + 1) * per_cta)), the depth D in stages of 32.
template <bool kVec, bool kResidentA>
__global__ void __launch_bounds__(kGemmThreads, 1)
    attn_bwd_product_kernel(const ElemT* __restrict__ d_hpre,
                            const ElemT* __restrict__ w1,
                            const float* __restrict__ att,
                            const ElemT* __restrict__ g,
                            ElemT* __restrict__ d_bs, ElemT* __restrict__ d_bt,
                            int N, int K2, int C, int D, int n_items,
                            int per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr gfla::WarpGrid kGrid = gfla::attn_grid();
  const float inv_k2 = 1.0f / static_cast<float>(K2);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kAttnTile;
  const int per_item = (D + gfla::kAttnDepth - 1) / gfla::kAttnDepth;
  const int item0 = blockIdx.y * per_cta;
  const int my_items = max(0, min(per_cta, n_items - item0));

  auto tiles = [&](int step) {
    const gfla::OffsetRun it = gfla::bwd_item(item0 + step / per_item, C);
    const int d0 = (step % per_item) * gfla::kAttnDepth;
    const size_t w_row = static_cast<size_t>(2 * it.m + it.h) * C + it.c0;
    using Stage =
        std::conditional_t<kBf16, gfla::Bf16Stage, gfla::GemmStage>;
    return Stage{
        {d_hpre + static_cast<size_t>(p0) * D + d0, static_cast<size_t>(D),
         N - p0, D - d0},
        {w1 + w_row * D + d0, static_cast<size_t>(D), C - it.c0, D - d0}};
  };
  // columns 2 q and 2 q + 1 of the item: channels c and c + 1. A row's g
  // values are all loaded before its first store, which might alias them
  // as far as the compiler knows.
  auto epilogue = [&](int item, const float(&sum)[64]) {
    const gfla::OffsetRun it = gfla::bwd_item(item0 + item, C);
    ElemT* out = it.h ? d_bs : d_bt;
    const bool pairs = C % 2 == 0;  // 8-byte aligned pairs
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows r and r + 8
      const int p = p0 + gfla::grid_row(kGrid, warp, lane, 0, 2 * half);
      if (p >= N) continue;
      const size_t row = (static_cast<size_t>(p) * K2 + it.m) * C;
      const int c_first = it.c0 + gfla::grid_col(kGrid, warp, lane, 0, 0);
      float2 ag[16];  // (1/k^2) attn g at channels c, c + 1
      if (it.h) {
        const float w = inv_k2 * att[static_cast<size_t>(p) * K2 + it.m];
        const ElemT* gp = g + static_cast<size_t>(p) * C;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = c_first + 8 * j;
          float2 v = make_float2(0.0f, 0.0f);
          if constexpr (kBf16) {
            if (pairs && c < C) {
              const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(
                  gp + c));
              v = make_float2(gfla::bf16_float(u & 0xffffu),
                              gfla::bf16_float(u >> 16));
            } else {
              if (c < C) v.x = gfla::to_float(__ldg(gp + c));
              if (c + 1 < C) v.y = gfla::to_float(__ldg(gp + c + 1));
            }
          } else if (pairs && c < C) {
            v = __ldg(reinterpret_cast<const float2*>(gp + c));
          } else {
            if (c < C) v.x = __ldg(gp + c);
            if (c + 1 < C) v.y = __ldg(gp + c + 1);
          }
          ag[j] = make_float2(w * v.x, w * v.y);
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c_first + 8 * j;
        if (c >= C) continue;
        float v0 = sum[4 * j + 2 * half];
        float v1 = sum[4 * j + 2 * half + 1];
        const bool two = c + 1 < C;
        if (it.h) {
          v0 += ag[j].x;
          v1 += ag[j].y;
        }
        ElemT* to = out + row + c;
        if constexpr (kBf16) {  // rounded to bf16; 4-byte pairs
          const uint16_t b0 = gfla::bf16_bits(v0);
          const uint16_t b1 = gfla::bf16_bits(v1);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(to) = b0 | (uint32_t{b1} << 16);
          } else {
            to[0] = b0;
            if (two) to[1] = b1;
          }
        } else if (GFLA_SPLIT == 3) {
          if (v0 == -1.2345e-38f) *to = v1;  // keeps the product live
        } else if (pairs) {
          *reinterpret_cast<float2*>(to) = make_float2(v0, v1);
        } else {
          to[0] = v0;
          if (two) to[1] = v1;
        }
      }
    }
  };
#if GFLA_ATTN_BF16
  gfla::bf16_gemm_walk<kVec, false>(reinterpret_cast<uint16_t*>(smem_raw),
                                    my_items * per_item, per_item, tiles,
                                    epilogue);
#else
  gfla::gemm_walk<kVec, kResidentA>(gfla::gemm_ring(smem_raw),
                                    my_items * per_item, per_item, tiles,
                                    epilogue);
#endif
}

// kResidentA: d_hpre's D <= 128 hidden units stay in shared memory for the
// whole CTA, so only W1 is copied and split a stage (attn_math_steps.cuh);
// a wider D does not fit and streams with W1. The bf16 walk has one form.
template <bool kVec, bool kResidentA>
int launch_product(const gfla::AttnBwdPlan& plan, const ElemT* d_hpre,
                   const ElemT* w1, const float* att, const ElemT* g,
                   ElemT* d_bs, ElemT* d_bt, int N, int k2, int C, int D,
                   cudaStream_t stream) {
  const size_t smem = kBf16 ? gfla::bf16_gemm_smem_bytes()
                            : gfla::gemm_smem_bytes(kResidentA);
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_product_kernel<kVec, kResidentA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(plan.tiles, plan.splits);
  attn_bwd_product_kernel<kVec, kResidentA>
      <<<grid, kGemmThreads, smem, stream>>>(d_hpre, w1, att, g, d_bs, d_bt,
                                             N, k2, C, D, plan.items,
                                             plan.per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch(const ElemT* bs, const float* hpre, const ElemT* g,
           const ElemT* w1, const ElemT* w2, const ElemT* b2, ElemT* d_bs,
           ElemT* d_bt, ElemT* d_hpre, float* scratch, float* sums, int N,
           int k2, int C, int D, float slope, cudaStream_t stream) {
  const int row_ctas = (N + kAttnRowPos - 1) / kAttnRowPos;
  float* part = scratch;
  float* att = scratch + static_cast<size_t>(row_ctas) * (D * k2 + D + k2);
  const size_t rows_smem = rows_smem_bytes(k2, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_rows_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(rows_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_rows_kernel<kVec><<<row_ctas, kGemmThreads, rows_smem, stream>>>(
      bs, hpre, g, w2, b2, d_hpre, att, part, N, k2, C, D, slope);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;

  const gfla::AttnBwdPlan plan = gfla::attn_bwd_plan(N, C, k2);
  if constexpr (kBf16) {
    e = launch_product<kVec, false>(plan, d_hpre, w1, att, g, d_bs, d_bt, N,
                                    k2, C, D, stream);
  } else {
    e = D <= gfla::kGemmResidentStages * gfla::kAttnDepth
            ? launch_product<kVec, true>(plan, d_hpre, w1, att, g, d_bs,
                                         d_bt, N, k2, C, D, stream)
            : launch_product<kVec, false>(plan, d_hpre, w1, att, g, d_bs,
                                          d_bt, N, k2, C, D, stream);
  }
  if (e != 0) return e;
  return gfla::launch_reduce(part, row_ctas,
                             static_cast<size_t>(D) * k2 + D + k2, sums,
                             stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

#if GFLA_ATTN_BF16
#define GFLA_ATTN_BWD gfla_attn_math_bwd_bf16
#else
#define GFLA_ATTN_BWD gfla_attn_math_bwd

// Scratch size, in floats, that the wrapper allocates: the per-position
// kernel's partial sums and the softmax it hands to the product kernel (the
// bf16 instance's too).
extern "C" long long gfla_attn_math_bwd_scratch(int N, int k2, int D) {
  return static_cast<long long>((N + kAttnRowPos - 1) / kAttnRowPos) *
             (static_cast<long long>(D) * k2 + D + k2) +
         static_cast<long long>(N) * k2;
}
#endif

// bs (N, k2, C); hpre (N, D): the forward's pre-activation hidden layer; g
// (N, C); w1 (k2, 2C, D); w2 (D, k2); b2 (k2). Outputs: d_bs, d_bt
// (N, k2, C); d_hpre (N, D); sums (D*k2 + D + k2): dW2 (D, k2), then db1
// (D), then db2 (k2). scratch: gfla_attn_math_bwd_scratch floats. float32,
// contiguous, on one device; D at most 256. gfla_attn_math_bwd_bf16: bs, g,
// w1, w2, b2, d_bs, d_bt and d_hpre in bf16 (bits); hpre, scratch and sums
// f32. Returns a cudaError_t; 0 means every launch was accepted.
extern "C" int GFLA_ATTN_BWD(const ElemT* bs, const float* hpre,
                             const ElemT* g, const ElemT* w1,
                             const ElemT* w2, const ElemT* b2, ElemT* d_bs,
                             ElemT* d_bt, ElemT* d_hpre, float* scratch,
                             float* sums, int N, int k2, int C, int D,
                             float slope, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || k2 < 1 || C < 1 || D < 1 || D > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // kVec: 16-byte copies of the product's operands (rows of D values) and
  // vector loads of the per-position kernel's bs and g rows (C values)
  const bool vec = (kBf16 ? C % 8 == 0 && D % 8 == 0
                          : C % 4 == 0 && D % 4 == 0) &&
                   aligned16(bs) && aligned16(g) && aligned16(w1) &&
                   aligned16(d_hpre);
  if (vec) {
    return launch<true>(bs, hpre, g, w1, w2, b2, d_bs, d_bt, d_hpre, scratch,
                        sums, N, k2, C, D, slope, s);
  }
  return launch<false>(bs, hpre, g, w1, w2, b2, d_bs, d_bt, d_hpre, scratch,
                       sums, N, k2, C, D, slope, s);
}
