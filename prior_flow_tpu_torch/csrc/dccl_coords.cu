// DCCL cross tap coords: both branches at every pyramid level in one launch,
// or one branch at one level.
//
// Replaces prior_flow_tpu/ops/pallas/dccl_gather.py::_coords_kernel
// (launched by dccl_grid_coords) and tools/microbench_gridwin.py::
// _pair_kernel (launched by pair_call): the grid-window stage of the lookup
// alone. For every centre n, level l and tap k = i*9 + j of the 9x9 window
// (x-offset i-4, y-offset j-4):
//   (cx, cy)[l, n, k] = sample(grid, cen[n]*scale[l] + (i-4, j-4))
// with the wrap-x bilinear sampler of dccl_common.cuh; branch A samples
// gridA at cenA, branch B gridB at cenB. The body is kernel 1's grid-window
// stage (dccl_columns.cuh::column_taps), built with --fmad=false like every
// source, so these coords are bit-identical to the ones the lookup kernels
// sample with and to the plain version's. The level's scale is applied
// inside: a power of two scales exactly, so cen * 2^-l here is the
// pre-scaled centre at scale 1.
//
// Bound on the card: bytes. Each (centre, branch, level) writes 2 x 81 f32
// (648 B) and reads its centre (8 B); the (Hg, Wg, 2) grids stay in L1/L2.
// About 31 f32 operations per tap (the x half shared by 9 taps).
//
// Design: one thread per (centre, branch, window column i), 288 threads a
// block (16 centres x 2 branches x 9 columns, or 32 centres of one branch).
// The 9 taps of a column share their x, so the x half of the bilinear
// corners is taken once per column, and each tap reuses the row pair the tap
// above it read where its top row is that tap's bottom row (ColumnSampler):
// a column reads 10 row pairs of grid cells instead of 9 x 4 corners. The
// block's coords are staged in shared memory and leave as whole rows: the
// block's rows are one contiguous run of each (N, 81) output, stored 16
// bytes a thread. The level is blockIdx.y. The stage holds no volume state,
// so it fits 40 registers a thread without spilling: 5 blocks (45 warps)
// per SM, 20.25 KB of shared memory each. tools/coords_occupancy.py timed
// one 1024x2048 iteration (both branches, 4 levels) on an H100 80GB HBM3 at
// 700 W: 0.0819 ms queued at 5 blocks per SM, 0.0867 at 4 (56 registers),
// 0.0869 at 6 and 7 (32 registers, spilling to the stack). The TPU
// kernel's one-hot strip matmul over grid rows, its 128-lane padding and
// packed grid planes work around the TPU's lack of gathers and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_columns.cuh"
#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
using dccl::kWin;

constexpr int kThreads = 288;
constexpr int kBlocksPerSM = 5;
constexpr int kMaxLevels = 8;

struct Scales {
  float s[kMaxLevels];
};

// The outputs: x and y of branch A, then of branch B (unused with one
// branch), each (L*N, 81) f32, level l's rows at l*N.
struct Out {
  float* xy[4];
};

// One block: centres q0 .. q0 + QB - 1 of level blockIdx.y, BR branches.
template <int BR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dccl_cross_coords_kernel(const float2* __restrict__ cenA,
                             const float2* __restrict__ cenB,
                             const float2* __restrict__ gridA,
                             const float2* __restrict__ gridB, Out out,
                             Scales scales, long long N, int Hg, int Wg) {
  constexpr int QB = kThreads / (BR * kWin);
  // [x A, y A, x B, y B] x QB rows of 81
  __shared__ __align__(16) float stage[2 * BR][QB * kTaps];
  const int l = blockIdx.y;
  const long long q0 = static_cast<long long>(blockIdx.x) * QB;
  const int tid = threadIdx.x;
  const int br = tid / (QB * kWin);
  const int r = tid - br * QB * kWin;
  const int ql = r / kWin;
  const int i = r - ql * kWin;
  const long long q = q0 + ql;
  if (q < N) {
    const int at = ql * kTaps + i * kWin;   // stride 9 across threads
    dccl::column_taps<dccl::kGridTaps, float>(
        nullptr, nullptr, __ldg((br ? cenB : cenA) + q), br ? gridB : gridA,
        i, 0, 0, Hg, Wg, scales.s[l], &stage[2 * br][at],
        &stage[2 * br + 1][at]);
  }
  __syncthreads();
  const long long left = N - q0;
  const int n = (left < QB ? static_cast<int>(left) : QB) * kTaps;
  const long long row0 = (static_cast<long long>(l) * N + q0) * kTaps;
#pragma unroll
  for (int a = 0; a < 2 * BR; ++a) {
    dccl::store_run<kThreads>(out.xy[a] + row0, stage[a], n, tid);
  }
}

template <int BR>
int launch(const void* cenA, const void* cenB, const void* gridA,
           const void* gridB, Out out, const Scales& scales, int L,
           long long N, int Hg, int Wg, void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int QB = kThreads / (BR * kWin);
  const dim3 blocks(static_cast<unsigned int>((N + QB - 1) / QB),
                    static_cast<unsigned int>(L));
  dccl_cross_coords_kernel<BR><<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(cenA), static_cast<const float2*>(cenB),
      static_cast<const float2*>(gridA), static_cast<const float2*>(gridB),
      out, scales, N, Hg, Wg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int.

// Both branches, L <= 8 levels: cenA, cenB (N, 2) f32 unscaled centres;
// gridA, gridB (Hg, Wg, 2) f32; scales: L floats; xA, yA, xB, yB: (L*N, 81)
// f32, level after level.
extern "C" int dccl_cross_coords(int L, const void* cenA, const void* cenB,
                                 const void* gridA, const void* gridB,
                                 void* xA, void* yA, void* xB, void* yB,
                                 long long N, int Hg, int Wg,
                                 const float* scales, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Scales s = {};
  for (int l = 0; l < L; ++l) s.s[l] = scales[l];
  const Out out = {{static_cast<float*>(xA), static_cast<float*>(yA),
                    static_cast<float*>(xB), static_cast<float*>(yB)}};
  return launch<2>(cenA, cenB, gridA, gridB, out, s, L, N, Hg, Wg, stream);
}

// One branch, one level: cen (N, 2) f32, grid (Hg, Wg, 2) f32; cx, cy
// (N, 81) f32.
extern "C" int dccl_grid_coords(const void* cen, const void* grid, void* cx,
                                void* cy, long long N, int Hg, int Wg,
                                float scale, void* stream) {
  Scales s = {};
  s.s[0] = scale;
  const Out out = {{static_cast<float*>(cx), static_cast<float*>(cy),
                    nullptr, nullptr}};
  return launch<1>(cen, cen, grid, grid, out, s, 1, N, Hg, Wg, stream);
}
