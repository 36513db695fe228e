// Streaming max-correlation, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_corr.py::_kernel (launched by max_corr_pallas).
// For every target row t_j of a batch element it finds
//     cmax_j = max_i <s_i, t_j>  and  argmax_j = the first such i
// over all source rows, without writing the (Ns x Nt) correlation to memory.
//
// What bounds it on this card: at the relu3_1 site of the correctness loss
// (B=8, Ns=Nt=4096, C=256) the products are 2*8*4096^2*256 = 68.7 GFLOP
// against 67 MB of inputs: compute-bound on the FP32 cores (TF32 would change
// which index wins a near-tie, so the tensor cores are not used).
//
// What this design does about it: it is an f32 matrix product with a
// (max, argmax) epilogue. A CTA of 256 threads owns 128 target rows and walks
// over 128-row source tiles (the loop inside the block replaces the TPU's
// sequential grid axis); C streams through shared memory 8 channels at a
// time. Each thread computes an 8 x 8 register tile of the correlation, so
// each shared-memory float4 feeds 4 FMAs per operand, and folds every source
// tile into a running (max, argmax) per row in registers, skipping the ragged
// tile's rows past Ns. The 16 threads that share a row merge by shuffle. When
// the grid would leave SMs idle (few target tiles), the source axis is split
// across CTAs and a second kernel merges the partials in order. Every merge
// uses gfla::corr_beats (max_corr.cuh), so ties go to the first index, as
// gfla_tpu's do. The TPU kernel's padding of C to 128 and its 1024-row target
// tile are Mosaic layout rules and have no counterpart here.
#include <cuda_runtime.h>

#include <cmath>

#include "max_corr.cuh"

namespace {

constexpr int kRowsT = 128;  // target rows per CTA
constexpr int kRowsS = 128;  // source rows per tile
constexpr int kDepth = 8;    // channels per shared-memory stage
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 2;

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    max_corr_kernel(const float* __restrict__ s, const float* __restrict__ t,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    int B, int Ns, int Nt, int C, int tiles_per_split) {
  __shared__ __align__(16) float ts[kDepth][kRowsT];
  __shared__ __align__(16) float ss[kDepth][kRowsS];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // source column group
  const int ty = tid >> 4;  // target row group
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int j0 = blockIdx.x * kRowsT;
  const float* tb = t + static_cast<size_t>(b) * Nt * C;
  const float* sb = s + static_cast<size_t>(b) * Ns * C;
  const int n_tiles = (Ns + kRowsS - 1) / kRowsS;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);

  // staging: thread tid loads row tid / 2, channels 4 * (tid % 2) + 0..3
  const int load_row = tid >> 1;
  const int load_c = (tid & 1) * 4;

  float best[8];
  int best_i[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    best[r] = -INFINITY;
    best_i[r] = gfla::kNoIndex;
  }

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int i0 = tile * kRowsS;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    }
    for (int c0 = 0; c0 < C; c0 += kDepth) {
      __syncthreads();  // the previous stage is consumed
      const int j = j0 + load_row;
      const int i = i0 + load_row;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + load_c + q;
        ts[load_c + q][load_row] =
            (j < Nt && c < C) ? tb[static_cast<size_t>(j) * C + c] : 0.0f;
        ss[load_c + q][load_row] =
            (i < Ns && c < C) ? sb[static_cast<size_t>(i) * C + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&ts[kk][4 * ty]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&ts[kk][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ss[kk][4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&ss[kk][64 + 4 * tx]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(a[r], v[q], acc[r][q]);
        }
      }
    }
    // fold the tile in; a thread's columns come in increasing source index,
    // so a strict > keeps the first of equal values
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = i0 + gfla::corr_tile_row(tx, q);
      if (i >= Ns) continue;  // rows past Ns count as -inf
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (acc[r][q] > best[r]) {
          best[r] = acc[r][q];
          best_i[r] = i;
        }
      }
    }
  }

  // the 16 threads of a row group are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int i = __shfl_xor_sync(0xffffffffu, best_i[r], off);
      if (gfla::corr_beats(v, i, best[r], best_i[r])) {
        best[r] = v;
        best_i[r] = i;
      }
    }
  }
  if (tx == 0) {
    const size_t base = (static_cast<size_t>(split) * B + b) * Nt;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = j0 + gfla::corr_tile_row(ty, r);
      if (j < Nt) {
        part_v[base + j] = best[r];
        part_i[base + j] = best_i[r];
      }
    }
  }
}

// cmax/argmax[e] from the partials of the n_splits source ranges.
__global__ void max_corr_merge(const float* __restrict__ part_v,
                               const int* __restrict__ part_i, int n_splits,
                               int n, float* __restrict__ cmax,
                               long long* __restrict__ amax) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    float best = -INFINITY;
    int best_i = gfla::kNoIndex;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float v = part_v[static_cast<size_t>(sp) * n + e];
      const int i = part_i[static_cast<size_t>(sp) * n + e];
      if (gfla::corr_beats(v, i, best, best_i)) {
        best = v;
        best_i = i;
      }
    }
    cmax[e] = best;
    amax[e] = best_i;
  }
}

}  // namespace

// Number of source ranges to split Ns into on the current device, so that
// the grid fills its SMs: the only place that decides it. The wrapper sizes
// n_splits * B * Nt partials of each type from it and passes it on.
extern "C" int gfla_max_corr_splits(int B, int Ns, int Nt) {
  int device = 0;
  int sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int n_tiles = (Ns + kRowsS - 1) / kRowsS;
  const long long ctas = static_cast<long long>(B) *
                         ((Nt + kRowsT - 1) / kRowsT);
  const long long want = static_cast<long long>(sms) * kCtasPerSm;
  long long splits = (want + ctas - 1) / ctas;
  if (splits > n_tiles) splits = n_tiles;
  if (splits < 1) splits = 1;
  const int per = static_cast<int>((n_tiles + splits - 1) / splits);
  return (n_tiles + per - 1) / per;  // no split left without a tile
}

// s (B,Ns,C), t (B,Nt,C): float32, contiguous, one device. part_v/part_i:
// n_splits * B * Nt floats / ints of scratch, n_splits from
// gfla_max_corr_splits. Writes cmax (B,Nt) float32 and amax (B,Nt) int64.
// Returns a cudaError_t; 0 means both launches were accepted.
extern "C" int gfla_max_corr(const float* s, const float* t, float* part_v,
                             int* part_i, float* cmax, long long* amax, int B,
                             int Ns, int Nt, int C, int n_splits,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Ns + kRowsS - 1) / kRowsS;
  if (n_splits < 1 || n_splits > n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (n_tiles + n_splits - 1) / n_splits;
  const dim3 grid((Nt + kRowsT - 1) / kRowsT, n_splits, B);
  max_corr_kernel<<<grid, kThreads, 0, st>>>(s, t, part_v, part_i, B, Ns, Nt,
                                              C, per);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = B * Nt;
  const int threads = 256;
  const int blocks = min((n + threads - 1) / threads, 4096);
  max_corr_merge<<<blocks, threads, 0, st>>>(part_v, part_i, n_splits, n,
                                             cmax, amax);
  return static_cast<int>(cudaGetLastError());
}
