// The column body of the DCCL level lookup: one thread per (query, branch,
// window column i), 16 queries per block, outputs staged in shared memory
// and stored in runs of 81 floats at a caller's row stride.
//
// dccl_lookup.cu runs it whole (kernels 1 and 4, kAllTaps); dccl_stages.cu
// runs it with stages left out (the own taps, the grid window, or the grid
// window and the cross taps), so that the stages' times split kernel 1's
// own; dccl_coords.cu runs the grid window's column_taps in a block of its
// own, which stores whole rows (store_run), and gridwin_variants.cu runs it
// on grids staged in shared memory. A stage left out is not computed at
// all; the stages that run do kernel 1's arithmetic in its order, so they
// give its bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace dccl {

// queries per block; threads = queries x 2 branches x 9 columns
constexpr int kQB = 16;
constexpr int kColThreads = kQB * 2 * kWin;
// at least 4 blocks (36 warps) per SM: at most 56 registers a thread. The
// latency of the gathers, not the arithmetic, sets a column's time, so
// warps in flight count for more than the few spilled registers.
constexpr int kColBlocksPerSM = 4;

// The stages of a column, as bits of the body's STAGES argument.
constexpr int kOwnTaps = 1;    // the own 9 taps in the own volume
constexpr int kGridTaps = 2;   // the grid window: the 9 cross tap coords
constexpr int kCrossTaps = 4;  // the 9 cross taps in the other volume
constexpr int kAllTaps = kOwnTaps | kGridTaps | kCrossTaps;

// Outputs of one level: four arrays of rows, row q at q * ld. With kAllTaps
// (own A, cross A, own B, cross B); with kGridTaps alone the cross tap
// coords (x A, y A, x B, y B); a stage that writes two arrays leaves the
// others unused (null).
struct LevelOut {
  float* ownA;
  float* crossA;
  float* ownB;
  float* crossB;
};

// Copies n floats from shared `src` (16-byte aligned) to `dst` with a
// block of THREADS threads: 16 bytes a thread from dst's first 16-byte
// boundary on.
template <int THREADS>
__device__ __forceinline__ void store_run(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n, int tid) {
  const int pad = static_cast<int>(
      (0u - static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst) >> 2)) &
      3u);
  const int head = pad < n ? pad : n;
  if (tid < head) dst[tid] = src[tid];
  const int quads = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  if (head == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int e = tid; e < quads; e += THREADS) d4[e] = s4[e];
  } else {
    for (int e = tid; e < quads; e += THREADS) {
      const float* s = src + head + 4 * e;
      d4[e] = make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  for (int e = head + 4 * quads + tid; e < n; e += THREADS) dst[e] = src[e];
}

// The 9 taps of window column i of one branch: the own taps in `own`, the
// cross taps (the grid sampled at the own coords, then the other volume) in
// `other`; results into s_own[j], s_cross[j] (with kGridTaps alone: the
// coords' x and y). The own column first, then the column's 9 grid samples,
// then their 9 gathers, so that each group's reads are independent of one
// another. GridFetch reads grid cells from `grid`: the read-only cache
// (GlobalGrid), or a copy of the grid in shared memory.
template <int STAGES, typename T, class GridFetch = GlobalGrid>
__device__ __forceinline__ void column_taps(
    const T* __restrict__ own, const T* __restrict__ other, float2 cen,
    const float2* __restrict__ grid, int i, int Hl, int Wl, int Hg, int Wg,
    float scale, float* s_own, float* s_cross) {
  // window_coord's arithmetic, its x shared by the column
  const float x = cen.x * scale + static_cast<float>(i - kRadius);
  const float ys = cen.y * scale;
  if (STAGES & kOwnTaps) {
    ColumnSampler<float> vol(Hl, Wl, x);
    const PlaneRead<T> rv{own};
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      s_own[j] = vol.tap(rv, ys + static_cast<float>(j - kRadius));
    }
  }
  if (STAGES & kGridTaps) {
    ColumnSampler<float2> grd(Hg, Wg, x);
    const GridFetch rg{grid};
    float2 p[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      p[j] = grd.tap(rg, ys + static_cast<float>(j - kRadius));
    }
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      if (STAGES & kCrossTaps) {
        s_cross[j] = sample_plane(other, Hl, Wl, p[j].x, p[j].y);
      } else {
        s_own[j] = p[j].x;
        s_cross[j] = p[j].y;
      }
    }
  }
}

// One block: queries q0 .. q0 + kQB - 1 of one level.
template <int STAGES, typename T>
__device__ __forceinline__ void level_columns(
    const T* __restrict__ volA, const T* __restrict__ volB,
    const float2* __restrict__ cenA, const float2* __restrict__ cenB,
    const float2* __restrict__ gridA, const float2* __restrict__ gridB,
    LevelOut out, long long ld, int BQ, int Hl, int Wl, int Hg, int Wg,
    float scale) {
  // which of the two arrays per branch the stages write
  constexpr bool kFirst = (STAGES & kOwnTaps) || STAGES == kGridTaps;
  constexpr bool kSecond = (STAGES & kGridTaps) != 0;
  // [own A, cross A, own B, cross B] x kQB rows of 81
  __shared__ float stage[4][kQB * kTaps];
  const long long q0 = static_cast<long long>(blockIdx.x) * kQB;
  const int tid = threadIdx.x;
  const int br = tid / (kQB * kWin);        // 0: branch A, 1: branch B
  const int r = tid - br * kQB * kWin;      // kQB x 9 columns
  const int ql = r / kWin;
  const int i = r - ql * kWin;
  const long long q = q0 + ql;
  if (q < BQ) {
    const size_t plane = static_cast<size_t>(Hl) * Wl;
    const T* vA = volA + static_cast<size_t>(q) * plane;
    const T* vB = volB + static_cast<size_t>(q) * plane;
    const int at = ql * kTaps + i * kWin;   // stride 9 across threads
    column_taps<STAGES>(br ? vB : vA, br ? vA : vB,
                        __ldg((br ? cenB : cenA) + q), br ? gridB : gridA, i,
                        Hl, Wl, Hg, Wg, scale, &stage[2 * br][at],
                        &stage[2 * br + 1][at]);
  }
  __syncthreads();
  const long long left = BQ - q0;
  const int n = (left < kQB ? static_cast<int>(left) : kQB) * kTaps;
  float* const dst[4] = {out.ownA, out.crossA, out.ownB, out.crossB};
  for (int e = tid; e < n; e += kColThreads) {
    const int row = e / kTaps;
    const long long o = (q0 + row) * ld + (e - row * kTaps);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a % 2 == 0 ? kFirst : kSecond) dst[a][o] = stage[a][e];
    }
  }
}

}  // namespace dccl
