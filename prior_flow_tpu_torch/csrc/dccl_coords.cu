// DCCL cross tap coords for one branch at one pyramid level.
//
// Replaces prior_flow_tpu/ops/pallas/dccl_gather.py::_coords_kernel
// (launched by dccl_grid_coords): only the grid-window stage of the lookup.
// For every centre n and every tap k = i*9 + j of the 9x9 window (x-offset
// i-4, y-offset j-4):
//   (cx, cy)[n, k] = sample(grid, cen[n]*scale + (i-4, j-4))
// with the wrap-x bilinear sampler of dccl_common.cuh. The lookup kernel
// takes its cross tap coords from the same header function under the same
// --fmad=false build, so these coords are bit-identical to the ones the
// lookup sampled with; the taped backward recomputes them here instead of
// keeping every iteration's coords.
//
// Bound on the card: bytes. A launch reads N centres (8 B each) and writes
// 2 x N x 81 f32 (648 B per centre); the (Hg, Wg, 2) grid stays in L1/L2.
// About 50 f32 operations per tap.
//
// Design: one thread per (centre, tap); the 81 threads of a centre share
// its load and the two output rows are written coalesced. The TPU kernel's
// one-hot strip matmul over grid rows, its 128-lane padding and the packed
// grid planes work around the TPU's lack of gathers and are not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dccl_coords_kernel(const float2* __restrict__ cen,
                       const float2* __restrict__ grid,
                       float* __restrict__ cx, float* __restrict__ cy,
                       long long N, int Hg, int Wg, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= N * kTaps) return;
  const long long n = t / kTaps;
  const int k = static_cast<int>(t - n * kTaps);
  const float2 p = dccl::cross_coord(grid, Hg, Wg, __ldg(cen + n), scale, k);
  cx[t] = p.x;
  cy[t] = p.y;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() as an int.
extern "C" int dccl_grid_coords(const void* cen, const void* grid, void* cx,
                                void* cy, long long N, int Hg, int Wg,
                                float scale, void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  const long long total = N * kTaps;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  dccl_coords_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(cen), static_cast<const float2*>(grid),
      static_cast<float*>(cx), static_cast<float*>(cy), N, Hg, Wg, scale);
  return static_cast<int>(cudaGetLastError());
}
