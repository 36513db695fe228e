// Streaming max-correlation, for Hopper (sm_90a).
//
// Replaces gfla_tpu/ops/pallas_corr.py::_kernel (launched by max_corr_pallas).
// For every target row t_j of a batch element it finds
//     cmax_j = max_i <s_i, t_j>  and  argmax_j = the first such i
// over all source rows, without writing the (Ns x Nt) correlation to memory.
//
// What bounds it on this card: at the relu3_1 site of the correctness loss
// (B=8, Ns=Nt=4096, C=256) the products are 2*8*4096^2*256 = 68.7 GFLOP
// against 67 MB of inputs: operations, not bytes. One TF32 product would move
// a correlation by more than the gap that decides an index, so the products
// are split-f32 (mma_tf32x3.cuh): three tensor-core products per f32
// product, which bounds the kernel at 495 / 3 = 165 TFLOP/s of f32 work,
// 2.5x what the FP32 cores offer.
//
// What this design does about it: target rows are M, source rows are N and C
// is the depth; both inputs are row-major with C innermost, the depth-major
// operand layout that wgmma takes for TF32, so nothing is transposed. A CTA
// of two warpgroups owns 128 target rows and walks over 128-row source tiles
// (the loop inside the block replaces the TPU's sequential grid axis). A
// ring of kStages stages, each 128 + 128 rows x 32 channels, is filled by
// cp.async, 16 bytes a thread, into the 128-byte-swizzled layout wgmma reads.
// Every thread then splits the values it copied itself into a hi and a lo
// tile, once per value instead of once per fragment that holds it, while the
// tensor cores work on the stage before: each warpgroup multiplies its 64
// target rows by the 128 source rows as m64n128k8 wgmma products, both
// operands from shared memory, the two small products before the large one.
// The ragged edge in rows and in C is zero-filled by the copy itself. The
// tensor cores add into their accumulator by truncation, which over a whole
// row of positive terms sums to ~2e-6 of the result; so every stage starts
// from 0 and is added to the running sum by the FP32 cores, rounding to
// nearest. At the end of a source tile each thread folds its two rows of
// sums into a running (max, argmax), skipping rows past Ns, and the four
// lanes of a quad merge by shuffle. When the target tiles would leave SMs
// idle, the source axis is split across CTAs and a second kernel merges the
// partials. Every element is summed by the same instruction sequence wherever
// it lies, so equal rows give bitwise equal correlations, and every fold
// uses gfla::corr_beats (max_corr.cuh), so ties go to the first index, as
// gfla_tpu's do. The TPU kernel's padding of C to 128 and its 1024-row target
// tile are Mosaic layout rules and have no counterpart here.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "max_corr.cuh"

#ifndef GFLA_SPLIT
#define GFLA_SPLIT 0  // tools/kernel_split.py builds timing variants; 0: none
#endif

namespace {

constexpr int kRows = gfla::kCorrRows;  // target rows a CTA, source a tile
constexpr int kChunk = 32;              // channels per stage: 128 bytes a row
constexpr int kStages = 3;
constexpr int kThreads = 32 * gfla::kCorrWarps;
constexpr int kFrags = gfla::corr_grid().tiles_n;  // 8-column fragments
constexpr int kTileBytes = kRows * kChunk * sizeof(float);
// a stage: target hi, target lo, source hi, source lo; copies land in hi
constexpr int kStageBytes = 4 * kTileBytes;
constexpr int kAlign = 1024;  // of every tile, for the swizzle
constexpr size_t kSmemBytes = kStages * kStageBytes + kAlign;

// Copy r of a stage that thread `tid` makes, the same for both operands and
// for every stage: kPer floats from channel cc of row `row` of the tile to
// byte `off` of its shared-memory image. kVec: C is a multiple of 4 and both
// tensors are 16-byte aligned, so a copy is 16 bytes and a thread makes 4 a
// tile, which it works out once; else 4 bytes and 16, worked out on the way.
template <bool kVec>
struct Copy {
  static constexpr int kPer = kVec ? 4 : 1;
  static constexpr int kAcross = kChunk / kPer;
  static constexpr int kCount = kRows * kAcross / kThreads;
  static constexpr int kKept = kVec ? kCount : 1;
  int row, cc, off;
  __device__ __forceinline__ Copy() {}
  __device__ __forceinline__ Copy(int tid, int r) {
    const int idx = tid + r * kThreads;
    row = idx / kAcross;
    cc = kPer * (idx % kAcross);
    off = gfla::swizzle128(row, cc);
  }
};

template <bool kVec>
struct Copies {
  Copy<kVec> kept[Copy<kVec>::kKept];
  int tid;
  __device__ __forceinline__ explicit Copies(int tid_) : tid(tid_) {
#pragma unroll
    for (int r = 0; r < Copy<kVec>::kKept; ++r) kept[r] = Copy<kVec>(tid, r);
  }
  __device__ __forceinline__ Copy<kVec> operator[](int r) const {
    return kVec ? kept[kVec ? r : 0] : Copy<kVec>(tid, r);
  }
};

// Start the copies of one stage: channels c0.. of the target rows from `tb`
// and the source rows from `sb`, of which `nt` and `ns` exist; zero-filled
// past them and past C.
template <bool kVec>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const Copies<kVec>& copies,
                                           const float* tb, const float* sb,
                                           int nt, int ns, int c0, int C) {
#pragma unroll 4
  for (int r = 0; r < Copy<kVec>::kCount; ++r) {
    const Copy<kVec> cp = copies[r];
    const int c = c0 + cp.cc;
    const int at = cp.row * C + c;
    const bool t_ok = cp.row < nt && c < C;
    const bool s_ok = cp.row < ns && c < C;
    if (kVec) {
      gfla::cp_async16(stage + cp.off, t_ok ? tb + at : tb, t_ok);
      gfla::cp_async16(stage + 2 * kTileBytes + cp.off, s_ok ? sb + at : sb,
                       s_ok);
    } else {
      gfla::cp_async4(stage + cp.off, t_ok ? tb + at : tb, t_ok);
      gfla::cp_async4(stage + 2 * kTileBytes + cp.off, s_ok ? sb + at : sb,
                      s_ok);
    }
  }
}

// Split what this thread copied into a stage: hi stays in place, lo goes to
// the tile behind it.
template <bool kVec>
__device__ __forceinline__ void split_stage(unsigned char* stage,
                                            const Copies<kVec>& copies) {
#pragma unroll 4
  for (int r = 0; r < Copy<kVec>::kCount; ++r) {
    const Copy<kVec> cp = copies[r];
#pragma unroll
    for (int op = 0; op < 2; ++op) {
      float* hi =
          reinterpret_cast<float*>(stage + 2 * op * kTileBytes + cp.off);
      float* lo = reinterpret_cast<float*>(stage + (2 * op + 1) * kTileBytes +
                                           cp.off);
      if (kVec) {
        const float4 v = *reinterpret_cast<const float4*>(hi);
        const gfla::Tf32Pair x = gfla::tf32_split(v.x);
        const gfla::Tf32Pair y = gfla::tf32_split(v.y);
        const gfla::Tf32Pair z = gfla::tf32_split(v.z);
        const gfla::Tf32Pair w = gfla::tf32_split(v.w);
        *reinterpret_cast<float4*>(hi) = make_float4(x.hi, y.hi, z.hi, w.hi);
        *reinterpret_cast<float4*>(lo) = make_float4(x.lo, y.lo, z.lo, w.lo);
      } else {
        const gfla::Tf32Pair x = gfla::tf32_split(*hi);
        *hi = x.hi;
        *lo = x.lo;
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    max_corr_kernel(const float* __restrict__ s, const float* __restrict__ t,
                    float* __restrict__ part_v, int* __restrict__ part_i,
                    float* __restrict__ cmax, long long* __restrict__ amax,
                    int B, int Ns, int Nt, int C, int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  constexpr gfla::WarpGrid kGrid = gfla::corr_grid();
  // the ring, on a 1024-byte boundary of the shared-memory window
  unsigned char* ring =
      smem_raw + ((kAlign - static_cast<uint32_t>(__cvta_generic_to_shared(
                                smem_raw))) & (kAlign - 1));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = warp >> 2;  // warpgroup: target rows 64 group ..
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int j0 = blockIdx.x * kRows;
  const float* tb = t + (static_cast<size_t>(b) * Nt + j0) * C;
  const float* sb = s + static_cast<size_t>(b) * Ns * C;
  const int n_tiles = (Ns + kRows - 1) / kRows;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int n_chunks = (C + kChunk - 1) / kChunk;
  const int steps = (tile_end - tile_begin) * n_chunks;
  const Copies<kVec> copies(tid);

  // The copies run two stages ahead of the products: their own walk over
  // (source tile, chunk, ring stage). One commit per call, empty past the
  // end, so the group count stays in step.
  int load_tile = tile_begin;
  int load_c0 = 0;
  int load_slot = 0;
  auto start_copies = [&]() {
    if (load_tile < tile_end) {
      load_stage<kVec>(ring + load_slot * kStageBytes, copies, tb,
                       sb + static_cast<size_t>(load_tile) * kRows * C,
                       Nt - j0, Ns - load_tile * kRows, load_c0, C);
      load_c0 += kChunk;
      if (load_c0 >= C) {
        load_c0 = 0;
        ++load_tile;
      }
      if (++load_slot == kStages) load_slot = 0;
    }
    gfla::cp_async_commit();
  };
  start_copies();
  start_copies();
  gfla::cp_async_wait<1>();  // this thread's copies of stage 0 are in
  split_stage<kVec>(ring, copies);
  gfla::fence_proxy_async();
  __syncthreads();

  float acc[4 * kFrags];  // the stage's products
  float sum[4 * kFrags];  // the source tile's, so far
#pragma unroll
  for (int e = 0; e < 4 * kFrags; ++e) {
    acc[e] = 0.0f;
    sum[e] = 0.0f;
  }
  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {gfla::kNoIndex, gfla::kNoIndex};

  int chunk = 0;
  int tile = tile_begin;
  int slot = 0;  // ring stage of `step`
  for (int step = 0; step < steps; ++step) {
    unsigned char* stage = ring + slot * kStageBytes;
    if (++slot == kStages) slot = 0;
    if (GFLA_SPLIT != 1) {
      // 64 target rows of this warpgroup x 128 source rows, 8 channels a
      // product; the two small products before the large one
      const uint64_t t_hi =
          gfla::wgmma_desc(stage + group * (kTileBytes / 2));
      const uint64_t t_lo =
          gfla::wgmma_desc(stage + kTileBytes + group * (kTileBytes / 2));
      const uint64_t s_hi = gfla::wgmma_desc(stage + 2 * kTileBytes);
      const uint64_t s_lo = gfla::wgmma_desc(stage + 3 * kTileBytes);
      gfla::wgmma_fence_operand(acc);
      gfla::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        gfla::wgmma_tf32(acc, t_lo + 2 * kk, s_hi + 2 * kk, kk > 0);
        gfla::wgmma_tf32(acc, t_hi + 2 * kk, s_lo + 2 * kk, 1);
        gfla::wgmma_tf32(acc, t_hi + 2 * kk, s_hi + 2 * kk, 1);
      }
      gfla::wgmma_commit();
    }
    // while they run: split the next stage, then start the copies two
    // stages on, into the ring stage whose products ended before the last
    // barrier
    gfla::cp_async_wait<0>();  // this thread's copies of step + 1 are in
    if (step + 1 < steps) {
      split_stage<kVec>(ring + slot * kStageBytes, copies);
    }
    gfla::fence_proxy_async();
    start_copies();
    gfla::wgmma_wait<0>();
    gfla::wgmma_fence_operand(acc);
#pragma unroll
    for (int e = 0; e < 4 * kFrags; ++e) sum[e] += acc[e];
    if (++chunk == n_chunks) {
      // a source tile is complete: fold it in; rows past Ns count as -inf
      const int i0 = tile * kRows;
#pragma unroll
      for (int nt = 0; nt < kFrags; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gfla::grid_col(kGrid, warp, lane, nt, e);
          const int r = gfla::corr_slot(0, e);
          if (GFLA_SPLIT == 2) {
            best[r] += sum[4 * nt + e];
            best_i[r] = i;
          } else if (i < Ns) {
            gfla::corr_fold(sum[4 * nt + e], i, best[r], best_i[r]);
          }
          sum[4 * nt + e] = 0.0f;
        }
      }
      chunk = 0;
      ++tile;
    }
    __syncthreads();  // the split of step + 1 is everyone's; `stage` is free
  }

  // the four lanes of a quad hold the same two target rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int i = __shfl_xor_sync(0xffffffffu, best_i[r], off);
      gfla::corr_fold(v, i, best[r], best_i[r]);
    }
  }
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + gfla::grid_row(kGrid, warp, lane, 0, 2 * r);
    if (j >= Nt) continue;
    const size_t at = static_cast<size_t>(b) * Nt + j;
    if (gridDim.y == 1) {  // no other split: this is the result
      cmax[at] = best[r];
      amax[at] = best_i[r];
    } else {
      part_v[static_cast<size_t>(split) * B * Nt + at] = best[r];
      part_i[static_cast<size_t>(split) * B * Nt + at] = best_i[r];
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
      gfla::corr_fold(part_v[static_cast<size_t>(sp) * n + e],
                      part_i[static_cast<size_t>(sp) * n + e], best, best_i);
    }
    cmax[e] = best;
    amax[e] = best_i;
  }
}

template <bool kVec>
int launch(const float* s, const float* t, float* part_v, int* part_i,
           float* cmax, long long* amax, int B, int Ns, int Nt, int C,
           int n_splits, int per, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      max_corr_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Nt + kRows - 1) / kRows, n_splits, B);
  max_corr_kernel<kVec><<<grid, kThreads, kSmemBytes, st>>>(
      s, t, part_v, part_i, cmax, amax, B, Ns, Nt, C, per);
  return static_cast<int>(cudaGetLastError());
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
  return gfla::corr_splits(B, Ns, Nt, sms);
}

// s (B,Ns,C), t (B,Nt,C): float32, contiguous, one device. part_v/part_i:
// n_splits * B * Nt floats / ints of scratch, n_splits from
// gfla_max_corr_splits. Writes cmax (B,Nt) float32 and amax (B,Nt) int64.
// Returns a cudaError_t; 0 means every launch was accepted.
extern "C" int gfla_max_corr(const float* s, const float* t, float* part_v,
                             int* part_i, float* cmax, long long* amax, int B,
                             int Ns, int Nt, int C, int n_splits,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Ns + kRows - 1) / kRows;
  if (n_splits < 1 || n_splits > n_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (n_tiles + n_splits - 1) / n_splits;
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(s) |
                                  reinterpret_cast<uintptr_t>(t)) % 16 == 0;
  const int err =
      vec ? launch<true>(s, t, part_v, part_i, cmax, amax, B, Ns, Nt, C,
                         n_splits, per, st)
          : launch<false>(s, t, part_v, part_i, cmax, amax, B, Ns, Nt, C,
                          n_splits, per, st);
  if (err != 0 || n_splits == 1) return err;
  const int n = B * Nt;
  const int threads = 256;
  const int blocks = min((n + threads - 1) / threads, 4096);
  max_corr_merge<<<blocks, threads, 0, st>>>(part_v, part_i, n_splits, n,
                                             cmax, amax);
  return static_cast<int>(cudaGetLastError());
}
