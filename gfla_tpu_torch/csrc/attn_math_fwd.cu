// Local-attention math over gathered blocks, forward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_attn.py::_kernel (launched by
// _attn_math_pallas). The blocks are already gathered: bs, bt (N, k^2, C).
// Per position it computes
//     hpre   = [bt || bs] . W1 + b1                  (D units)
//     attn   = softmax(LeakyReLU(hpre) . W2 + b2)    (over the k^2 offsets)
//     out    = (1/k^2) sum_m attn_m * bs_m           (C channels)
// with W1 (k^2, 2C, D) as gfla_tpu lays it out, so the [bt || bs]
// concatenation is never built. Under grad the caller also passes an (N, D)
// buffer and hpre is stored there, so that the backward (attn_math_bwd.cu)
// starts from it instead of recomputing it.
//
// What bounds it on an H100: at the k=5 site of the DeepFashion generator
// (N = 8*64*64, k^2 = 25, C = 128, D = 128) the dense layer is 2 * N * 6400 *
// 128 = 53.7 GFLOP against 839 MB of bs and bt: operations. They run on the
// tensor cores as split-f32 products (mma_tf32x3.cuh), three TF32 products
// per f32 product, so the bound is 495 / 3 = 165 TFLOP/s of f32 work, 0.33
// ms; the blocks' bytes take 0.25 ms at 3.35 TB/s.
//
// What this design does about it: two kernels.
//  * attn_fwd_product_kernel: the dense layer as a GEMM, (positions) x
//    (k^2 2C) times W1, whose left operand is the blocks as they lie, on
//    wgmma (attn_math_steps.cuh): 128 positions x 128 hidden units a CTA,
//    the depth walked in stages of (offset, half, 32 channels)
//    (attn_math_tiles.cuh), so shared memory does not grow with C. wgmma
//    takes TF32 operands only with the depth innermost, which W1 (D
//    innermost) is not, so the wrapper passes the transposed copy W1^T (D x
//    k^2 2C), 3.3 MB at the k=5 site. When the position tiles alone would
//    leave SMs idle (the k=3 site) the depth is split over CTAs, each with
//    its own partial sum. mma.sync from fragments split at load, with the
//    epilogue below fused in, took 1.2x as long on an H100 (PERF.md,
//    section 6).
//  * attn_fwd_rows_kernel, 32 positions a CTA: hpre = the partials in a
//    fixed order + b1 (stored when asked), LeakyReLU, the logits, the
//    softmax over k^2 and the weighted sum on the FP32 cores, reading each
//    bs row 16 bytes a lane. It is memory-bound and small enough to keep
//    many CTAs an SM, where a fused epilogue would idle the tensor cores.
//
// bf16 (attn_math_fwd_bf16.cu builds this file with GFLA_ATTN_BF16 = 1,
// entry gfla_attn_math_fwd_bf16): gfla_tpu's _kernel with bf16 blocks and
// parameters (the `--compute_dtype=bfloat16` of GFLA_ATTN_PALLAS=1). It
// reads bs, bt, W1, b1, W2 and b2 in bf16 and writes out in bf16; hpre and
// the product's partial sums stay f32. The product is bf16 mma.sync
// m16n8k16 (attn_math_bf16.cuh) over W1 as it lies, (k^2 2C) x D, so no
// transposed copy is made; its bound is the tensor cores' 989 TFLOP/s bf16
// rate, well below the blocks' bytes (0.13 ms at the k=5 site). Where
// gfla_tpu's body rounds to bf16, this one does (pallas_attn.py:75-81): the
// hidden layer before W2, the attention weights before the weighted sum,
// and the f32 sum of the products attn_m bs_m (exact in f32) before it is
// divided by k^2 in bf16, as XLA runs the body, which keeps the products in
// f32; the logits and the softmax stay f32.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

// tools/kernel_split.py builds timing variants, each leaving one part out:
// 1 the product, 2 the tile copies and splits, 3 the weighted sum; 0 (the
// kernels) leaves nothing out.
#ifndef GFLA_SPLIT
#define GFLA_SPLIT 0
#endif

#ifndef GFLA_ATTN_BF16
#define GFLA_ATTN_BF16 0  // 1: the bf16 instance (attn_math_fwd_bf16.cu)
#endif

#include "attn_math_bf16.cuh"
#include "attn_math_steps.cuh"
#include "attn_math_tiles.cuh"

namespace {

using gfla::kAttnDepth;
using gfla::kAttnRowPos;
using gfla::kAttnTile;
using gfla::kGemmThreads;

constexpr bool kBf16 = GFLA_ATTN_BF16;
// the blocks, the parameters and the output: f32, or bf16 as bits
using ElemT = std::conditional_t<kBf16, uint16_t, float>;

// Grid (position tiles x column tiles, splits). CTA (x, y) writes
// part[y][p][d] = sum over its depth stages of [bt || bs][p] . W1[:, d] for
// the positions p and hidden units d of its tile. w1k: W1^T (D x k^2 2C) in
// f32, W1 itself ((k^2 2C) x D) in bf16.
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 1)
    attn_fwd_product_kernel(const ElemT* __restrict__ bs,
                            const ElemT* __restrict__ bt,
                            const ElemT* __restrict__ w1k,
                            float* __restrict__ part, int N, int K2, int C,
                            int D, int col_tiles, int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr gfla::WarpGrid kGrid = gfla::attn_grid();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = (blockIdx.x / col_tiles) * kAttnTile;
  const int n0 = (blockIdx.x % col_tiles) * kAttnTile;
  const int stages = gfla::attn_runs(K2, C, kAttnDepth);
  const int q0 = blockIdx.y * per_split;
  const int steps = max(0, min(per_split, stages - q0));
  const size_t ldx = static_cast<size_t>(K2) * C;  // a row of bt, bs
  const size_t ldw = 2 * ldx;                      // a row of W1^T

  auto tiles = [&](int step) {
    const gfla::OffsetRun ch = gfla::attn_run(q0 + step, C, kAttnDepth);
    const ElemT* x = ch.h ? bs : bt;
    const int cols = C - ch.c0;
    const size_t w_row = static_cast<size_t>(2 * ch.m + ch.h) * C + ch.c0;
#if GFLA_ATTN_BF16  // B: W1 rows w_row .. as depth, D innermost
    return gfla::Bf16Stage{
        {x + p0 * ldx + static_cast<size_t>(ch.m) * C + ch.c0, ldx, N - p0,
         cols},
        {w1k + w_row * D + n0, static_cast<size_t>(D), cols, D - n0}};
#else
    return gfla::GemmStage{
        {x + p0 * ldx + static_cast<size_t>(ch.m) * C + ch.c0, ldx, N - p0,
         cols},
        {w1k + n0 * ldw + w_row, ldw, D - n0, cols}};
#endif
  };
  float* out = part + static_cast<size_t>(blockIdx.y) * N * D;
  auto epilogue = [&](int, const float(&sum)[64]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gfla::grid_row(kGrid, warp, lane, 0, e);
        const int d = n0 + gfla::grid_col(kGrid, warp, lane, j, e);
        if (p < N && d < D) out[static_cast<size_t>(p) * D + d] = sum[4 * j + e];
      }
    }
  };
#if GFLA_ATTN_BF16
  gfla::bf16_gemm_walk<kVec, true>(reinterpret_cast<uint16_t*>(smem_raw),
                                   steps, steps, tiles, epilogue);
#else
  gfla::gemm_walk<kVec, false>(gfla::gemm_ring(smem_raw), steps, steps,
                               tiles, epilogue);
#endif
}

__host__ __device__ constexpr int rows_ld(int D) { return D + 1; }

size_t rows_smem_bytes(int k2, int D) {
  return sizeof(float) *
         (static_cast<size_t>(kAttnRowPos) * (rows_ld(D) + k2) + D * k2);
}

// CTA x: positions 32 x .., of which the first n_valid exist.
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads)
    attn_fwd_rows_kernel(const ElemT* __restrict__ bs,
                         const float* __restrict__ part, int splits,
                         const ElemT* __restrict__ b1,
                         const ElemT* __restrict__ w2,
                         const ElemT* __restrict__ b2, ElemT* __restrict__ out,
                         float* __restrict__ hpre, int N, int K2, int C,
                         int D, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int ld = rows_ld(D);
  float* hid = smem;                       // kAttnRowPos x ld
  float* att = hid + kAttnRowPos * ld;     // kAttnRowPos x K2
  float* w2s = att + kAttnRowPos * K2;     // D x K2
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kAttnRowPos;
  const int n_valid = min(kAttnRowPos, N - p0);
  const size_t ND = static_cast<size_t>(N) * D;

  // hpre = the partial sums in split order + b1; stored when asked (each
  // (t, d) is asked for once)
  auto hpre_row = [&](int t, int d) {
    const size_t at = static_cast<size_t>(p0 + t) * D + d;
    float h = 0.0f;
    for (int z = 0; z < splits; ++z) h += part[z * ND + at];
    h += gfla::to_float(b1[d]);
    if (hpre != nullptr) hpre[at] = h;
    return h;
  };
  gfla::rows_softmax(hpre_row, n_valid, w2, b2, hid, ld, w2s, att, K2, D,
                     slope);

  // out = (1/k^2) sum_m attn_m bs_m: 16 bytes of a bs row a lane
  const float scale = 1.0f / static_cast<float>(K2);
  const int C4 = (C + 3) / 4;
  for (int e = tid; e < n_valid * C4; e += kGemmThreads) {
    const int t = e / C4;
    const int c = 4 * (e - t * C4);
    const size_t p = static_cast<size_t>(p0 + t);
    const float* a = att + t * K2;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (GFLA_SPLIT == 3) {
      o.x = a[0];
    } else {
#pragma unroll 5
      for (int mm = 0; mm < K2; ++mm) {
        const float4 v = gfla::load4<kVec>(bs, p * K2 + mm, c, C);
        // in bf16 the weight is rounded; its products with bf16 values are
        // exact in f32
        const float w = kBf16 ? gfla::bf16_round(a[mm]) : a[mm];
        o = make_float4(fmaf(w, v.x, o.x), fmaf(w, v.y, o.y),
                        fmaf(w, v.z, o.z), fmaf(w, v.w, o.w));
      }
    }
    ElemT* to = out + p * C + c;
    if constexpr (kBf16) {  // the sum in bf16, then / k^2 in bf16
      const float k2f = static_cast<float>(K2);
      const uint16_t v[4] = {
          gfla::bf16_bits(gfla::bf16_round(o.x) / k2f),
          gfla::bf16_bits(gfla::bf16_round(o.y) / k2f),
          gfla::bf16_bits(gfla::bf16_round(o.z) / k2f),
          gfla::bf16_bits(gfla::bf16_round(o.w) / k2f)};
      if (kVec) {  // 8 bytes: C % 4 == 0, out 16-byte aligned
        *reinterpret_cast<uint2*>(to) =
            make_uint2(v[0] | (uint32_t{v[1]} << 16),
                       v[2] | (uint32_t{v[3]} << 16));
      } else {
        for (int u = 0; u < 4 && c + u < C; ++u) to[u] = v[u];
      }
    } else {
      o = make_float4(o.x * scale, o.y * scale, o.z * scale, o.w * scale);
      if (kVec) {
        *reinterpret_cast<float4*>(to) = o;
      } else {
        to[0] = o.x;
        if (c + 1 < C) to[1] = o.y;
        if (c + 2 < C) to[2] = o.z;
        if (c + 3 < C) to[3] = o.w;
      }
    }
  }
}

template <bool kVec>
int launch(const ElemT* bs, const ElemT* bt, const ElemT* w1k,
           const ElemT* b1, const ElemT* w2, const ElemT* b2, ElemT* out,
           float* hpre, float* part, int N, int k2, int C, int D, float slope,
           cudaStream_t stream) {
  const gfla::AttnFwdPlan plan = gfla::attn_fwd_plan(N, C, D, k2);
  const size_t gemm_smem = kBf16 ? gfla::bf16_gemm_smem_bytes()
                                 : gfla::gemm_smem_bytes(false);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_product_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gemm_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(plan.tiles * plan.col_tiles, plan.splits);
  attn_fwd_product_kernel<kVec>
      <<<grid, kGemmThreads, gemm_smem, stream>>>(
          bs, bt, w1k, part, N, k2, C, D, plan.col_tiles, plan.per_split);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;

  const size_t smem = rows_smem_bytes(k2, D);
  err = cudaFuncSetAttribute(attn_fwd_rows_kernel<kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_rows_kernel<kVec>
      <<<(N + kAttnRowPos - 1) / kAttnRowPos, kGemmThreads, smem, stream>>>(
          bs, part, plan.splits, b1, w2, b2, out, hpre, N, k2, C, D, slope);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

#if GFLA_ATTN_BF16
#define GFLA_ATTN_FWD gfla_attn_math_fwd_bf16
#else
#define GFLA_ATTN_FWD gfla_attn_math_fwd

// Scratch size, in floats, that the wrapper allocates: the product's
// partial sums, one (N, D) array per depth split (the bf16 instance's too).
extern "C" long long gfla_attn_math_fwd_scratch(int N, int k2, int C, int D) {
  return static_cast<long long>(gfla::attn_fwd_plan(N, C, D, k2).splits) *
         N * D;
}
#endif

// bs, bt (N, k2, C); w1k: W1 (k2, 2C, D), channels [target || source],
// transposed to (D, k2*2C) for gfla_attn_math_fwd and as it lies for
// gfla_attn_math_fwd_bf16; b1 (D); w2 (D, k2); b2 (k2); out (N, C):
// float32 (gfla_attn_math_fwd_bf16: bf16 as bits), contiguous, on one
// device; D at most 256. hpre: null, or (N, D) float32, which then gets the
// pre-activation hidden layer [bt || bs] . W1 + b1 for the backward.
// scratch: gfla_attn_math_fwd_scratch floats. Returns a cudaError_t; 0
// means every launch was accepted.
extern "C" int GFLA_ATTN_FWD(const ElemT* bs, const ElemT* bt,
                             const ElemT* w1k, const ElemT* b1,
                             const ElemT* w2, const ElemT* b2, ElemT* out,
                             float* hpre, float* scratch, int N, int k2,
                             int C, int D, float slope, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || k2 < 1 || C < 1 || D < 1 || D > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte copies: f32 rows of C floats; bf16 rows of C and of D values
  const bool vec = (kBf16 ? C % 8 == 0 && D % 8 == 0 : C % 4 == 0) &&
                   aligned16(bs) && aligned16(bt) && aligned16(w1k) &&
                   aligned16(out);
  if (vec) {
    return launch<true>(bs, bt, w1k, b1, w2, b2, out, hpre, scratch, N, k2,
                        C, D, slope, s);
  }
  return launch<false>(bs, bt, w1k, b1, w2, b2, out, hpre, scratch, N, k2, C,
                       D, slope, s);
}
