// Fused local-attention warp, forward, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_warp.py::_fwd_kernel (launched by
// _warp_fwd_pallas). Per output position it gathers the flow-displaced,
// edge-clamped k x k source block (bilinear, shared fractional weights),
// computes hidden = blocks . W1s + hidden_bt, LeakyReLU, logits = hidden . W2
// + b2, a softmax over the k^2 offsets, and out = (1/k^2) sum attn * block.
// The target stream hidden_bt (a plain k x k convolution plus b1) is computed
// outside, as gfla_tpu does. Under grad the caller also passes hpre, and the
// epilogue stores the pre-activation hidden layer there, so that the
// backward (warp_bwd.cu) starts from it instead of recomputing it.
//
// What bounds it on this card: at the k=5 site of the DeepFashion generator
// (B=8, 64x64, C=128, D=128) the dense layer is 8*4096 positions x 3200 x 128
// FMAs, about 27 GFLOP, against a few MB of source, flow and hidden_bt and a
// 1.6 MB W1s that stays in the 50 MB L2: operations. They run on the tensor
// cores as split-f32 products (mma_tf32x3.cuh), three TF32 products per f32
// product, so the bound is 495 / 3 = 165 TFLOP/s of f32 work. The product is
// mma.sync m16n8k8 from register fragments, which runs at half of wgmma's
// rate; wgmma takes TF32 operands only with the depth innermost, which W1s
// (k^2 C x D, D innermost) is not.
//
// What this design does about it: the dense layer is an implicit GEMM,
// (positions) x (k^2 C) times W1s (k^2 C x D), whose left operand is made by
// the gather. A CTA of 8 warps owns 64 positions and all D columns and walks
// the depth in chunks of (one offset, 32 channels), so shared memory does not
// grow with C. W1s chunks come by cp.async through a ring of three stages.
// The left operand cannot come by a copy, since each value blends four
// clamped taps; it is pipelined in software instead: every thread loads the
// taps of the next chunk, 16 bytes along C at a time, before the products of
// the current chunk, and blends and stores them after, into the other of two
// buffers. Each position's clamped tap rows and columns and its four blend
// weights are computed once per CTA. Both operands are split into hi and lo
// as fragments are loaded; rows are padded so that fragment loads meet no
// bank conflict, and C and D are zero-padded to the tile in shared memory.
// The logits and the softmax stay on the FP32 cores (0.2 GFLOP in all), with
// every thread at work. The output is not gathered block by block: all k^2
// offsets share the blend weights, so sum_m attn_m block_m is a sum over the
// (k+1)^2 footprint cells, each with a coefficient of at most four
// attn x weight terms: (k+1)^2 loads per channel instead of 4 k^2.
// The kernel takes k at run time, any k in 1..9, odd or even (an even block
// reaches one row and column further up and left than down and right, as
// gfla_tpu's block_extract offsets i - k/2; warp_common.cuh's footprint
// follows it): nothing in it is sized by k but shared memory.
//
// Above k = 9, the wide instance (kWide), which takes every k gfla_tpu's
// Pallas warp does: nothing in it is sized by k. The product is the same
// (the taps' rows and columns clamped as they are loaded, from each
// position's footprint, in place of the tables); the logits go to a scratch
// of B*H*W x k^2 floats in device memory, and a warp per position takes the
// softmax over them in strides of 32 offsets and the weighted sum over the
// footprint cells, each cell's weight made from the attention weights
// where it is used (warp_cells.cuh's cell_coef), 4 channels a lane. Its
// product sums each chunk of 32 channels from 0 on the tensor cores and
// adds it to the running sum on the FP32 cores (as the dW1s kernel does):
// the tensor cores add by truncation, and over a depth of k^2 C = 21632
// (k = 13, C = 128) that alone left hpre 1.2e-4 of its max off the plain
// product's.
//
// bf16 (warp_fwd_bf16.cu builds this file with GFLA_WARP_BF16 = 1, entry
// gfla_warp_fwd_bf16): gfla_tpu's kernel with a bf16 source
// (pallas_warp.py:435-451). It reads the source and W2 in bf16 and blends
// in f32, as gfla_tpu's _prep widens the source, and W1s widened to f32 by
// the wrapper (exact), so the ring and its copies are the f32 kernel's. Where
// gfla_tpu's body rounds to bf16, this one does: the blended block (:183),
// the hidden layer before W2 (:195) and the attention weights (:200); every
// sum stays f32. The product is one bf16 mma.sync m16n8k16 per 16 deep
// (mma_bf16.cuh) in place of six TF32 products, so its bound is the tensor
// cores' 989 TFLOP/s bf16 rate. The weighted sum is taken over the footprint
// cells, from the unrounded blend, and the output is stored in bf16.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32x3.cuh"
#include "warp_cells.cuh"
#include "warp_common.cuh"

#ifndef GFLA_WARP_BF16
#define GFLA_WARP_BF16 0  // 1: the bf16 instances (warp_fwd_bf16.cu)
#endif

#ifndef GFLA_SPLIT
#define GFLA_SPLIT 0  // tools/kernel_split.py builds timing variants; 0: none
#endif

namespace {

constexpr int kPos = 64;     // positions per CTA: 2 rows of warps x 32
constexpr int kChunk = 32;   // channels per depth chunk
constexpr int kLda = gfla::mma_row_stride(kChunk);
constexpr int kStagesB = 3;  // W1s ring
constexpr int kThreads = 256;
constexpr int kMaxK = 9;     // the widest block of the k <= 9 instances
constexpr bool kBf16 = GFLA_WARP_BF16;
// the source, W2 and the output: f32, or bf16 as bits
using SrcT = std::conditional_t<kBf16, uint16_t, float>;

// a value at a point where gfla_tpu's bf16 body rounds it
__device__ __forceinline__ float at_bf16(float x) {
  return kBf16 ? gfla::bf16_round(x) : x;
}

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

// Four channels from c of pixel `pix` of an NHWC image, zero past C, as
// floats. kVec: C is a multiple of 4 and the tensor 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 load4(const SrcT* __restrict__ img,
                                        int pix, int c, int C) {
  const SrcT* at = img + static_cast<size_t>(pix) * C + c;
  if (kVec) {
    return c < C ? gfla::ldg4(at) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(c < C ? gfla::to_float(__ldg(at)) : 0.0f,
                     c + 1 < C ? gfla::to_float(__ldg(at + 1)) : 0.0f,
                     c + 2 < C ? gfla::to_float(__ldg(at + 2)) : 0.0f,
                     c + 3 < C ? gfla::to_float(__ldg(at + 3)) : 0.0f);
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 acc) {
  return make_float4(fmaf(w, v.x, acc.x), fmaf(w, v.y, acc.y),
                     fmaf(w, v.z, acc.z), fmaf(w, v.w, acc.w));
}

// Where the walk over the depth stands: channels c0.. of offset m = i * K + j.
// All K^2 offsets of one chunk of channels come before the next chunk:
// neighbouring offsets share half their taps, which then hit L1.
struct Cursor {
  int m, i, j, c0;
  __device__ __forceinline__ void advance(int K) {
    ++m;
    if (++j == K) {
      j = 0;
      if (++i == K) {
        i = 0;
        m = 0;
        c0 += kChunk;
      }
    }
  }
};

// Channels c..c+3 of output position p from their f32 sums, zero past C.
template <bool kVecA>
__device__ __forceinline__ void store_out4(SrcT* __restrict__ out, int p,
                                           int c, int C, float4 o) {
  SrcT* to = out + static_cast<size_t>(p) * C + c;
  if constexpr (kBf16) {
    const uint16_t v[4] = {gfla::bf16_bits(o.x), gfla::bf16_bits(o.y),
                           gfla::bf16_bits(o.z), gfla::bf16_bits(o.w)};
    if (kVecA) {  // 8 bytes: C % 4 == 0, out 16-byte aligned
      *reinterpret_cast<uint2*>(to) =
          make_uint2(v[0] | (uint32_t{v[1]} << 16),
                     v[2] | (uint32_t{v[3]} << 16));
    } else {
      for (int u = 0; u < 4 && c + u < C; ++u) to[u] = v[u];
    }
  } else if (kVecA) {
    *reinterpret_cast<float4*>(to) = o;
  } else {
    to[0] = o.x;
    if (c + 1 < C) to[1] = o.y;
    if (c + 2 < C) to[2] = o.z;
    if (c + 3 < C) to[3] = o.w;
  }
}

// NT: 8-column fragments per warp, so the tile is 32 NT >= D columns wide.
// kVecA: C % 4 == 0 and source and out 16-byte aligned; kVecB: D % 4 == 0 and
// W1s 16-byte aligned. kWide: the instance for k above kMaxK, whose logits
// go to att_g (N x k^2; null for the others).
template <int NT, bool kVecA, bool kVecB, bool kWide>
__global__ void __launch_bounds__(kThreads)
    warp_fwd_kernel(const SrcT* __restrict__ src,
                    const float* __restrict__ flow,
                    const float* __restrict__ hbt,
                    const float* __restrict__ w1s,
                    const SrcT* __restrict__ w2,
                    const float* __restrict__ b2, SrcT* __restrict__ out,
                    float* __restrict__ hpre, float* __restrict__ att_g,
                    int N, int H, int W, int C, int D, int K, float slope) {
  // two rows of four warps, each warp 32 positions x 8 NT hidden units
  constexpr gfla::WarpGrid kGrid{4, 2, NT};
  constexpr int kCols = 32 * NT;
  constexpr int kLdb = gfla::mma_col_stride(kCols);
  constexpr int kLdh = kCols + 4;
  constexpr int kRing = 2 * kPos * kLda + kStagesB * kChunk * kLdb;
  static_assert(kPos * kLdh <= kRing, "hid must fit into the ring it reuses");
  const int K2 = K * K;
  const int K1 = K + 1;

  extern __shared__ __align__(16) float smem[];
  float* a_ring = smem;                   // 2 x kPos x kLda
  float* b_ring = smem + 2 * kPos * kLda; // kStagesB x kChunk x kLdb
  float* hid = smem;                      // kPos x kLdh, once the ring is free
  float* att = smem + kRing;              // kPos x K2 (none when wide)
  float* coef = att + (kWide ? 0 : kPos * K2);  // kPos x K1 x K1 (none)
  gfla::TapWeights* wts = reinterpret_cast<gfla::TapWeights*>(
      coef + (kWide ? 0 : kPos * K1 * K1));  // kPos
  int* rowoff = reinterpret_cast<int*>(wts + kPos);  // kPos x K1: pixel of
  int* col = rowoff + kPos * K1;          // (row, 0) in the batch; column
  // wide: each position's footprint and batch element in place of the tables
  gfla::Footprint* fpw = reinterpret_cast<gfla::Footprint*>(wts + kPos);
  int* bat = reinterpret_cast<int*>(fpw + kPos);
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
  const int p0 = blockIdx.x * kPos;
  const int HW = H * W;

  for (int t = tid; t < kPos; t += kThreads) {
    const int p = p0 + t;
    if (p < N) {
      const int b = p / HW;
      const int rem = p - b * HW;
      const int y = rem / W;
      const int x = rem - y * W;
      const gfla::Footprint fp =
          gfla::footprint(flow[2 * p], flow[2 * p + 1], y, x, H, W, K);
      wts[t] = gfla::tap_weights(fp.wy, fp.wx);
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
      wts[t] = gfla::TapWeights{0.0f, 0.0f, 0.0f, 0.0f};
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
  __syncthreads();

  // ---- hidden = blocks . W1s over chunks of (offset, 32 channels) ---------
  // Gather: thread tid blends channels gc..gc+3 of positions gp and gp + 32.
  const int gp = tid >> 3;
  const int gc = 4 * (tid & 7);
  const gfla::TapWeights tw[2] = {wts[gp], wts[gp + 32]};

  auto load_taps = [&](const Cursor& cur, float4 (&taps)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (GFLA_SPLIT == 2) {
#pragma unroll
        for (int q = 0; q < 4; ++q) taps[h][q] = make_float4(1, 1, 1, 1);
        continue;
      }
      const int t = gp + 32 * h;
      const int r0 = row_off(t, cur.i), r1 = row_off(t, cur.i + 1);
      const int x0 = col_at(t, cur.j), x1 = col_at(t, cur.j + 1);
      const int c = cur.c0 + gc;
      taps[h][0] = load4<kVecA>(src, r0 + x0, c, C);
      taps[h][1] = load4<kVecA>(src, r0 + x1, c, C);
      taps[h][2] = load4<kVecA>(src, r1 + x0, c, C);
      taps[h][3] = load4<kVecA>(src, r1 + x1, c, C);
    }
  };
  auto store_blend = [&](const float4 (&taps)[2][4], float* stage) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v = fma4(tw[h].tl, taps[h][0], v);
      v = fma4(tw[h].tr, taps[h][1], v);
      v = fma4(tw[h].bl, taps[h][2], v);
      v = fma4(tw[h].br, taps[h][3], v);
      v = make_float4(at_bf16(v.x), at_bf16(v.y), at_bf16(v.z), at_bf16(v.w));
      *reinterpret_cast<float4*>(stage + (gp + 32 * h) * kLda + gc) = v;
    }
  };
  // rows m C + c0 .. + 31 of W1s, all D columns, into one ring stage; one
  // commit per call, empty past the end, so the group count stays in step
  auto copy_b = [&](const Cursor& cur, bool live, float* stage) {
    if (live) {
      constexpr int kPer = kVecB ? 4 : 1;
      constexpr int kAcross = kCols / kPer;
#pragma unroll
      for (int r = 0; r < kChunk * kAcross / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / kAcross;
        const int n = kPer * (idx % kAcross);
        const bool ok = cur.c0 + row < C && n < D;
        const float* from =
            ok ? w1s + static_cast<size_t>(cur.m * C + cur.c0 + row) * D + n
               : w1s;
        if (kVecB) {
          gfla::cp_async16(stage + row * kLdb + n, from, ok);
        } else {
          gfla::cp_async4(stage + row * kLdb + n, from, ok);
        }
      }
    }
    gfla::cp_async_commit();
  };

  const int n_chunks = K2 * ((C + kChunk - 1) / kChunk);
  Cursor next_a{0, 0, 0, 0};  // the chunk whose taps are loaded next
  Cursor next_b{0, 0, 0, 0};  // the chunk whose W1s rows are copied next
  int started_b = 0;
  float4 taps[2][4];
  for (; started_b < kStagesB - 1; ++started_b) {
    copy_b(next_b, started_b < n_chunks, b_ring + started_b * kChunk * kLdb);
    next_b.advance(K);
  }
  load_taps(next_a, taps);
  next_a.advance(K);
  store_blend(taps, a_ring);
  gfla::cp_async_wait<kStagesB - 2>();
  __syncthreads();

  float acc[2][NT][4];
  float sum[2][NT][4];  // wide: the chunks' sums (the narrow ones use acc)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = sum[mt][nt][e] = 0.0f;
    }
  }
  // this lane's first fragment elements: element e of an A fragment lies
  // 8 (e & 1) rows and 4 (e >> 1) channels on, of a B fragment 4 e rows on
  const int a_at =
      (gfla::grid_first_row(kGrid, warp) + gfla::mma_a_row(lane, 0)) * kLda +
      gfla::mma_a_depth(lane, 0);
  const int b_at = gfla::mma_b_depth(lane, 0) * kLdb +
                   gfla::grid_first_col(kGrid, warp) + gfla::mma_b_col(lane);

  int stage_b = 0;  // ring stage of chunk q
  for (int q = 0; q < n_chunks; ++q) {
    const bool more = q + 1 < n_chunks;
    if (more) load_taps(next_a, taps);  // in flight during the products
    next_a.advance(K);
    {
      int to = stage_b + kStagesB - 1;
      if (to >= kStagesB) to -= kStagesB;
      copy_b(next_b, started_b < n_chunks, b_ring + to * kChunk * kLdb);
      next_b.advance(K);
      ++started_b;
    }
    const float* a_st = a_ring + (q & 1) * kPos * kLda + a_at;
    const float* b_st = b_ring + stage_b * kChunk * kLdb + b_at;
    if (GFLA_SPLIT == 1) {
      acc[0][0][0] += a_st[0] + b_st[0];
    } else if (kBf16) {
      // 16 deep a step (mma_bf16.cuh's maps), from depth 0 of this lane's
      // first A row and B column
      const float* a16 = a_st - gfla::mma_a_depth(lane, 0);
      const float* b16 = b_st - gfla::mma_b_depth(lane, 0) * kLdb;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        uint32_t a[2][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(
                a16 + (16 * mt + 8 * (r & 1)) * kLda + 16 * kk +
                gfla::mma16_a_depth(lane, r, 0));
            a[mt][r] = gfla::pack_bf16x2(v.x, v.y);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float* at_b =
                b16 + (16 * kk + gfla::mma16_b_depth(lane, r, 0)) * kLdb +
                8 * nt;
            b[nt][r] = gfla::pack_bf16x2(at_b[0], at_b[kLdb]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            gfla::mma_bf16(acc[mt][nt], a[mt], b[nt]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        uint32_t a_hi[2][4], a_lo[2][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gfla::tf32_split_bits(
                a_st[(16 * mt + 8 * (e & 1)) * kLda + 8 * kk + 4 * (e >> 1)],
                a_hi[mt][e], a_lo[mt][e]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            gfla::tf32_split_bits(b_st[(8 * kk + 4 * e) * kLdb + 8 * nt],
                                  b_hi[nt][e], b_lo[nt][e]);
          }
        }
        // the two small products before the large one
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            gfla::mma_tf32(acc[mt][nt], a_lo[mt], b_hi[nt]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            gfla::mma_tf32(acc[mt][nt], a_hi[mt], b_lo[nt]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            gfla::mma_tf32(acc[mt][nt], a_hi[mt], b_hi[nt]);
          }
        }
      }
    }
    if constexpr (kWide) {
      // the tensor cores add by truncation, which a depth of k^2 C past
      // 10^4 makes felt: each chunk's products are summed from 0 and added
      // to the sum on the FP32 cores
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[mt][nt][e] += acc[mt][nt][e];
            acc[mt][nt][e] = 0.0f;
          }
        }
      }
    }
    // the other A buffer was last read one chunk ago, before a barrier
    if (more) store_blend(taps, a_ring + ((q + 1) & 1) * kPos * kLda);
    gfla::cp_async_wait<kStagesB - 2>();  // the next chunk of W1s is in
    __syncthreads();
    if (++stage_b == kStagesB) stage_b = 0;
  }
  gfla::cp_async_wait<0>();  // only empty groups are left; the ring is free

  // ---- + target stream (which carries b1) = hpre, stored when asked;
  // LeakyReLU -> hid --------------------------------------------------------
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = gfla::grid_row(kGrid, warp, lane, mt, e);
        const int n = gfla::grid_col(kGrid, warp, lane, nt, e);
        const int p = p0 + row;
        if (n < D) {
          float h = kWide ? sum[mt][nt][e] : acc[mt][nt][e];
          if (p < N) {
            h += hbt[static_cast<size_t>(p) * D + n];
            if (hpre != nullptr) hpre[static_cast<size_t>(p) * D + n] = h;
          }
          hid[row * kLdh + n] = at_bf16(h >= 0.0f ? h : h * slope);
        }
      }
    }
  }
  __syncthreads();

  if constexpr (kWide) {
    // ---- logits into this CTA's rows of the scratch -----------------------
    for (int e = tid; e < kPos * K2; e += kThreads) {
      const int t = e / K2;
      const int mm = e - t * K2;
      if (p0 + t >= N) continue;
      float s = 0.0f;
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(hid[t * kLdh + dd], gfla::to_float(w2[dd * K2 + mm]), s);
      }
      att_g[static_cast<size_t>(p0 + t) * K2 + mm] = s + b2[mm];
    }
    __syncthreads();
    // ---- a warp per position: the softmax over the k^2 offsets in strides
    // of 32, then out = sum over the footprint cells, 4 channels a lane ----
    for (int t = warp * (kPos / 8); t < (warp + 1) * (kPos / 8); ++t) {
      const int p = p0 + t;
      if (p >= N) break;
      float* a = att_g + static_cast<size_t>(p) * K2;
      float mx = -INFINITY;
      for (int m = lane; m < K2; m += 32) mx = fmaxf(mx, a[m]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int m = lane; m < K2; m += 32) sum += expf(a[m] - mx);
      sum = warp_sum(sum);
      for (int m = lane; m < K2; m += 32) {
        a[m] = at_bf16(expf(a[m] - mx) / sum);
      }
      __syncwarp();  // every lane's weights in for all
      const gfla::TapWeights w = wts[t];
      for (int c = 4 * lane; c < C; c += 4 * 32) {
        float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int r = 0; r < K1; ++r) {
          const int ro = row_off(t, r);
          for (int cc = 0; cc < K1; ++cc) {
            o = fma4(gfla::cell_coef(a, K, w, r, cc),
                     load4<kVecA>(src, ro + col_at(t, cc), c, C), o);
          }
        }
        store_out4<kVecA>(out, p, c, C, o);
      }
    }
  } else {
    // ---- logits, softmax over the k^2 offsets (a warp per 8 positions) ----
    for (int e = tid; e < kPos * K2; e += kThreads) {
      const int t = e / K2;
      const int mm = e - t * K2;
      float s = 0.0f;
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(hid[t * kLdh + dd], gfla::to_float(w2[dd * K2 + mm]), s);
      }
      att[e] = s + b2[mm];
    }
    __syncthreads();
    for (int t = warp * (kPos / 8); t < (warp + 1) * (kPos / 8); ++t) {
      float* a = att + t * K2;  // K2 <= 81: three values a lane
      constexpr int kVals = (kMaxK * kMaxK + 31) / 32;
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
        if (lane + 32 * u < K2) a[lane + 32 * u] = at_bf16(v[u] / sum);
      }
    }
    __syncthreads();

    // ---- out = (1/k^2) sum_m attn_m block_m over the footprint cells ------
    // cell (r, c) is the top-left tap of offset (r, c), the top-right of
    // (r, c-1), the bottom-left of (r-1, c) and the bottom-right of (r-1, c-1)
    const float scale = 1.0f / static_cast<float>(K2);
    for (int e = tid; e < kPos * K1 * K1; e += kThreads) {
      const int t = e / (K1 * K1);
      const int cell = e - t * K1 * K1;
      const int r = cell / K1;
      const int c = cell - r * K1;
      const float* a = att + t * K2;
      const gfla::TapWeights w = wts[t];
      float f = 0.0f;
      if (r < K && c < K) f = fmaf(w.tl, a[r * K + c], f);
      if (r < K && c > 0) f = fmaf(w.tr, a[r * K + c - 1], f);
      if (r > 0 && c < K) f = fmaf(w.bl, a[(r - 1) * K + c], f);
      if (r > 0 && c > 0) f = fmaf(w.br, a[(r - 1) * K + c - 1], f);
      coef[e] = f * scale;
    }
    __syncthreads();
    const int C4 = (C + 3) / 4;
    for (int e = tid; e < kPos * C4; e += kThreads) {
      const int t = e / C4;
      const int c = 4 * (e - t * C4);
      const int p = p0 + t;
      if (p >= N) continue;
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (GFLA_SPLIT == 3) {
        o.x = coef[t * K1 * K1];
      } else {
        for (int r = 0; r < K1; ++r) {
          const int ro = rowoff[t * K1 + r];
          for (int cc = 0; cc < K1; ++cc) {
            o = fma4(coef[(t * K1 + r) * K1 + cc],
                     load4<kVecA>(src, ro + col[t * K1 + cc], c, C), o);
          }
        }
      }
      store_out4<kVecA>(out, p, c, C, o);
    }
  }
}

template <int NT, bool kVecA, bool kVecB, bool kWide>
int launch(const SrcT* src, const float* flow, const float* hbt,
           const float* w1s, const SrcT* w2, const float* b2, SrcT* out,
           float* hpre, float* att_g, int N, int H, int W, int C, int D,
           int K, float slope, cudaStream_t stream) {
  const int K1 = K + 1;
  const size_t ring =
      sizeof(float) * (2 * kPos * kLda +
                       kStagesB * kChunk * gfla::mma_col_stride(32 * NT));
  const size_t smem =
      kWide ? ring + kPos * (sizeof(gfla::TapWeights) +
                             sizeof(gfla::Footprint) + sizeof(int))
            : ring + sizeof(float) * kPos * (K * K + K1 * K1) +
                  kPos * (sizeof(gfla::TapWeights) + 2 * K1 * sizeof(int));
  const cudaError_t err = cudaFuncSetAttribute(
      warp_fwd_kernel<NT, kVecA, kVecB, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kPos - 1) / kPos);
  warp_fwd_kernel<NT, kVecA, kVecB, kWide><<<grid, kThreads, smem, stream>>>(
      src, flow, hbt, w1s, w2, b2, out, hpre, att_g, N, H, W, C, D, K, slope);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_aligned(const SrcT* src, const float* flow, const float* hbt,
                   const float* w1s, const SrcT* w2, const float* b2,
                   SrcT* out, float* hpre, float* att_g, int N, int H, int W,
                   int C, int D, int K, float slope, cudaStream_t s) {
  const uintptr_t a_bits =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out);
  const bool vec_a = C % 4 == 0 && a_bits % 16 == 0;
  const bool vec_b = D % 4 == 0 && reinterpret_cast<uintptr_t>(w1s) % 16 == 0;
  if (K > kMaxK) {  // the wide instance: vector loads where both allow them
    if (vec_a && vec_b) {
      return launch<NT, true, true, true>(src, flow, hbt, w1s, w2, b2, out,
                                          hpre, att_g, N, H, W, C, D, K,
                                          slope, s);
    }
    return launch<NT, false, false, true>(src, flow, hbt, w1s, w2, b2, out,
                                          hpre, att_g, N, H, W, C, D, K,
                                          slope, s);
  }
  if (vec_a && vec_b) {
    return launch<NT, true, true, false>(src, flow, hbt, w1s, w2, b2, out,
                                         hpre, nullptr, N, H, W, C, D, K,
                                         slope, s);
  }
  if (vec_a) {
    return launch<NT, true, false, false>(src, flow, hbt, w1s, w2, b2, out,
                                          hpre, nullptr, N, H, W, C, D, K,
                                          slope, s);
  }
  if (vec_b) {
    return launch<NT, false, true, false>(src, flow, hbt, w1s, w2, b2, out,
                                          hpre, nullptr, N, H, W, C, D, K,
                                          slope, s);
  }
  return launch<NT, false, false, false>(src, flow, hbt, w1s, w2, b2, out,
                                         hpre, nullptr, N, H, W, C, D, K,
                                         slope, s);
}

}  // namespace

#if GFLA_WARP_BF16
#define GFLA_WARP_FWD gfla_warp_fwd_bf16
#define GFLA_WARP_FWD_SCRATCH gfla_warp_fwd_scratch_bf16
#else
#define GFLA_WARP_FWD gfla_warp_fwd
#define GFLA_WARP_FWD_SCRATCH gfla_warp_fwd_scratch
#endif

// Floats of the scratch the wrapper allocates: the wide instance's logits
// (N x k^2) above k = 9, none below. The bf16 instances have their own copy,
// so that a library of either alone is whole.
extern "C" long long GFLA_WARP_FWD_SCRATCH(int N, int k) {
  return k > kMaxK ? static_cast<long long>(N) * k * k : 0;
}

// source (B,H,W,C), flow (B,H,W,2) as (x, y), hbt (B*H*W, D), w1s (k*k*C, D),
// w2 (D, k*k), b2 (k*k), out (B,H,W,C): float32, contiguous, on one device;
// k >= 1; D at most 256. hpre: null, or (B*H*W, D), which then
// gets the pre-activation hidden layer blocks . W1s + hbt for the backward.
// scratch: gfla_warp_fwd_scratch floats (null where that is 0).
// gfla_warp_fwd_bf16: the same with source, W2 and out in bf16 (bits) and
// W1s holding bf16 values in f32. Returns a cudaError_t; 0 means the
// launch was accepted.
extern "C" int GFLA_WARP_FWD(const SrcT* src, const float* flow,
                             const float* hbt, const float* w1s,
                             const SrcT* w2, const float* b2, SrcT* out,
                             float* hpre, float* scratch, int B, int H, int W,
                             int C, int D, int k, float slope, void* stream) {
  const int N = B * H * W;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || D < 1 || D > 256 || (k > kMaxK && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D <= 32) {
    return launch_aligned<1>(src, flow, hbt, w1s, w2, b2, out, hpre, scratch,
                             N, H, W, C, D, k, slope, s);
  }
  if (D <= 64) {
    return launch_aligned<2>(src, flow, hbt, w1s, w2, b2, out, hpre, scratch,
                             N, H, W, C, D, k, slope, s);
  }
  if (D <= 128) {
    return launch_aligned<4>(src, flow, hbt, w1s, w2, b2, out, hpre, scratch,
                             N, H, W, C, D, k, slope, s);
  }
  return launch_aligned<8>(src, flow, hbt, w1s, w2, b2, out, hpre, scratch, N,
                           H, W, C, D, k, slope, s);
}

#if !GFLA_WARP_BF16
extern "C" const char* gfla_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif
