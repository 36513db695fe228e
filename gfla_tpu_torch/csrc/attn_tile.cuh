// Steps of the local-attention math that the attention kernels share
// (warp_fwd.cu, warp_bwd.cu, attn_math_fwd.cu, attn_math_bwd.cu).
//
// A CTA owns kTile consecutive positions, of which the first n_valid exist,
// and one thread per hidden unit: thread d < D owns unit d, and blockDim.x is
// at least D. Per-position rows live in shared memory: the hidden layer (or
// later d_hpre) with row stride ld >= D, the softmax and its cotangent with
// row stride K2. Functions that end with a barrier say so; every thread of
// the CTA must call those. Loops stride by blockDim.x held in an int: a
// loop index advanced by the unsigned blockDim.x made the attention-math
// backward markedly slower on an H100.
#pragma once

#include <cuda_runtime.h>

namespace gfla {

constexpr int kTile = 32;  // positions per CTA

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[t] += rows[t] . w[:, d] over C channels, for thread d. rows: kTile rows
// of stride Cp (C rounded up to a multiple of 4, zero-padded) in shared
// memory; wcol: column d of a row-major (C x D) weight block. Each weight is
// read once per CTA and each shared-memory float4 feeds four FMAs.
__device__ __forceinline__ void dense_accumulate(float (&acc)[kTile],
                                                 const float* rows, int Cp,
                                                 const float* wcol, int C,
                                                 int D) {
  for (int c = 0; c < Cp; c += 4) {
    const float wa = c < C ? wcol[static_cast<size_t>(c) * D] : 0.0f;
    const float wb = c + 1 < C ? wcol[static_cast<size_t>(c + 1) * D] : 0.0f;
    const float wc = c + 2 < C ? wcol[static_cast<size_t>(c + 2) * D] : 0.0f;
    const float wd = c + 3 < C ? wcol[static_cast<size_t>(c + 3) * D] : 0.0f;
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(rows + t * Cp + c);
      acc[t] = fmaf(v.x, wa, acc[t]);
      acc[t] = fmaf(v.y, wb, acc[t]);
      acc[t] = fmaf(v.z, wc, acc[t]);
      acc[t] = fmaf(v.w, wd, acc[t]);
    }
  }
}

// dense_accumulate over two operands at once, acc[t] += rows_a[t] . wa[:, d]
// + rows_b[t] . wb[:, d], interleaved per group of four channels, so that
// the eight strided weight loads of a group are issued together. The two
// sums one after the other made the attention-math backward slower on an
// H100.
__device__ __forceinline__ void dense_accumulate_pair(
    float (&acc)[kTile], const float* rows_a, const float* wcol_a,
    const float* rows_b, const float* wcol_b, int Cp, int C, int D) {
  for (int c = 0; c < Cp; c += 4) {
    float wa[4], wb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = c + q < C;
      wa[q] = in ? wcol_a[static_cast<size_t>(c + q) * D] : 0.0f;
      wb[q] = in ? wcol_b[static_cast<size_t>(c + q) * D] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float4 va = *reinterpret_cast<const float4*>(rows_a + t * Cp + c);
      const float4 vb = *reinterpret_cast<const float4*>(rows_b + t * Cp + c);
      float a = acc[t];
      a = fmaf(va.x, wa[0], a);
      a = fmaf(va.y, wa[1], a);
      a = fmaf(va.z, wa[2], a);
      a = fmaf(va.w, wa[3], a);
      a = fmaf(vb.x, wb[0], a);
      a = fmaf(vb.y, wb[1], a);
      a = fmaf(vb.z, wb[2], a);
      a = fmaf(vb.w, wb[3], a);
      acc[t] = a;
    }
  }
}

// rows_a[t] = xa[p0 + t][m] and rows_b[t] = xb[p0 + t][m] for two gathered
// (N, K2, C) tensors: offset m of the CTA's positions, zero past n_valid and
// in the pad channels C..Cp. One loop loads both, so that each thread has
// two global loads in flight; a loop per tensor made the attention-math
// backward slower on an H100.
__device__ __forceinline__ void stage_offset_pair(const float* xa,
                                                  const float* xb, int m,
                                                  int p0, int n_valid, int K2,
                                                  int C, int Cp,
                                                  float* rows_a,
                                                  float* rows_b) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int e = tid; e < kTile * Cp; e += nthreads) {
    const int t = e / Cp;
    const int c = e - t * Cp;
    const bool ok = t < n_valid && c < C;
    const size_t off = (static_cast<size_t>(p0 + t) * K2 + m) * C + c;
    rows_a[e] = ok ? xa[off] : 0.0f;
    rows_b[e] = ok ? xb[off] : 0.0f;
  }
}

// att[t] = softmax over the K2 offsets of hid[t] . W2 + b2, W2 (D, K2). Call
// once hid is complete (after a barrier); ends with a barrier.
__device__ __forceinline__ void logits_softmax(const float* hid, int ld,
                                               const float* w2,
                                               const float* b2, float* att,
                                               int K2, int D) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int e = tid; e < kTile * K2; e += nthreads) {
    const int t = e / K2;
    const int mm = e - t * K2;
    float s = 0.0f;
    for (int dd = 0; dd < D; ++dd) {
      s = fmaf(hid[t * ld + dd], w2[dd * K2 + mm], s);
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
}

// Softmax backward in place: dat[t] (d_attn) becomes d_logits =
// att[t] (dat[t] - <att[t], dat[t]>) for t < n_valid, and 0 past it, so the
// missing positions add nothing to the sums over positions. Ends with a
// barrier.
__device__ __forceinline__ void softmax_bwd(const float* att, float* dat,
                                            int n_valid, int K2) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int t = tid; t < kTile; t += nthreads) {
    const float* a = att + t * K2;
    float* da = dat + t * K2;
    if (t >= n_valid) {
      for (int mm = 0; mm < K2; ++mm) da[mm] = 0.0f;
      continue;
    }
    float s = 0.0f;
    for (int mm = 0; mm < K2; ++mm) s = fmaf(a[mm], da[mm], s);
    for (int mm = 0; mm < K2; ++mm) da[mm] = a[mm] * (da[mm] - s);
  }
  __syncthreads();
}

// This CTA's partial sums over its positions: dW2 = hid^T dat into
// part[0, D*K2) (row d by thread d) and db2 = sum_t dat into
// part[db2_at, db2_at + K2). dat holds d_logits, 0 past n_valid.
__device__ __forceinline__ void dw2_db2_partial(const float* hid, int ld,
                                                const float* dat, float* part,
                                                int db2_at, int K2, int D) {
  const int d = threadIdx.x;
  const int nthreads = blockDim.x;
  if (d < D) {
    for (int mm = 0; mm < K2; ++mm) {
      float s = 0.0f;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        s = fmaf(hid[t * ld + d], dat[t * K2 + mm], s);
      }
      part[d * K2 + mm] = s;
    }
  }
  for (int mm = d; mm < K2; mm += nthreads) {
    float s = 0.0f;
    for (int t = 0; t < kTile; ++t) s += dat[t * K2 + mm];
    part[db2_at + mm] = s;
  }
}

// For thread d < D: d_hpre[t] = LeakyReLU'(hpre[t]) (d_logits[t] . W2[d, :]),
// written to out row p0 + t (stride D) for t < n_valid and to hid[t][d],
// which gets 0 past n_valid. Returns the sum over t < n_valid: the CTA's
// share of db1.
__device__ __forceinline__ float d_hpre_rows(const float (&hpre)[kTile],
                                             const float* dat,
                                             const float* w2, float slope,
                                             float* hid, int ld, float* out,
                                             int p0, int n_valid, int K2,
                                             int D) {
  const int d = threadIdx.x;
  const float* w2row = w2 + d * K2;
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    float s = 0.0f;
    for (int mm = 0; mm < K2; ++mm) s = fmaf(dat[t * K2 + mm], w2row[mm], s);
    float dh = hpre[t] >= 0.0f ? s : s * slope;
    if (t < n_valid) {
      out[static_cast<size_t>(p0 + t) * D + d] = dh;
    } else {
      dh = 0.0f;
    }
    sum += dh;
    hid[t * ld + d] = dh;
  }
  return sum;
}

}  // namespace gfla
