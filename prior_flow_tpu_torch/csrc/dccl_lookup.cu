// DCCL level lookup, both branches, one pyramid level per launch.
//
// Replaces prior_flow_tpu/ops/pallas/dccl_gather.py::_dccl_grid_kernel
// (launched by _grid_call). For every query q of the batch and every tap
// k = i*9 + j of the 9x9 window (x-offset i-4, y-offset j-4):
//   own_A[q,k]   = sample(volA[q], c)           c = cenA[q]*scale + (i-4, j-4)
//   cross_A[q,k] = sample(volB[q], sample(gridA, c))
// and the same for branch B with the roles of the volumes swapped. The
// rotation grid is sampled at the level-scaled window coords and its result
// indexes the level volume unscaled: the reference's parity quirk.
//
// sample() is the wrap-x bilinear sampler of dccl_common.cuh, which the
// coords and scatter kernels share. The Pallas kernel clips an x that wraps
// to exactly Wl to column Wl-1; this kernel samples zero there, as the
// samplers do. Built with --fmad=false and with the operations in the plain
// version's order, so both round alike.
//
// Bound on the card: bytes. A launch reads each touched 32-byte sector of
// the two volumes (per query, the own 10x10 corner patch and the rotated
// cross patch in each volume: a small part of the 32 KB f32 plane a query
// has at level 0) and writes 4 x BQ x 81 f32 outputs (10.6 MB at
// BQ = 8192); the arithmetic is about 240 f32 operations per tap.
//
// Design: one thread per (query, tap); the 81 threads of a query share its
// centre load, the output rows are written fully coalesced, and corners are
// read through the read-only cache (__ldg). The TPU kernel's lane packing,
// row-select network, bf16 row-pair bitcasts and one-hot strip matmul work
// around the TPU's lack of gathers; Hopper gathers directly, so none of
// them is carried over. The two (Hg, Wg, 2) grids stay resident in L1/L2.
// Neighbouring taps differ in y, so they stride by Wl: a tap-major
// reordering is left for a later speed pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dccl_level_kernel(const T* __restrict__ volA, const T* __restrict__ volB,
                      const float2* __restrict__ cenA,
                      const float2* __restrict__ cenB,
                      const float2* __restrict__ gridA,
                      const float2* __restrict__ gridB,
                      float* __restrict__ ownA, float* __restrict__ crossA,
                      float* __restrict__ ownB, float* __restrict__ crossB,
                      int BQ, int Hl, int Wl, int Hg, int Wg, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(BQ) * kTaps) return;
  const int q = static_cast<int>(t / kTaps);
  const int k = static_cast<int>(t - static_cast<long long>(q) * kTaps);
  const size_t plane = static_cast<size_t>(Hl) * Wl;
  const T* vA = volA + static_cast<size_t>(q) * plane;
  const T* vB = volB + static_cast<size_t>(q) * plane;

  // branch A: own window in volume A, cross taps through grid A into B
  const float2 ca = __ldg(cenA + q);
  const float2 a = dccl::window_coord(ca, scale, k);
  ownA[t] = dccl::sample_plane(vA, Hl, Wl, a.x, a.y);
  const float2 pa = dccl::cross_coord(gridA, Hg, Wg, ca, scale, k);
  crossA[t] = dccl::sample_plane(vB, Hl, Wl, pa.x, pa.y);

  // branch B: own window in volume B, cross taps through grid B into A
  const float2 cb = __ldg(cenB + q);
  const float2 b = dccl::window_coord(cb, scale, k);
  ownB[t] = dccl::sample_plane(vB, Hl, Wl, b.x, b.y);
  const float2 pb = dccl::cross_coord(gridB, Hg, Wg, cb, scale, k);
  crossB[t] = dccl::sample_plane(vA, Hl, Wl, pb.x, pb.y);
}

}  // namespace

// Launches one level on `stream`; returns cudaGetLastError() as an int.
// vol_bf16 != 0 selects bf16 volumes (raw 16-bit words), else f32.
extern "C" int dccl_level_lookup(const void* volA, const void* volB,
                                 int vol_bf16, const void* cenA,
                                 const void* cenB, const void* gridA,
                                 const void* gridB, void* ownA, void* crossA,
                                 void* ownB, void* crossB, int BQ, int Hl,
                                 int Wl, int Hg, int Wg, float scale,
                                 void* stream) {
  if (BQ <= 0) return static_cast<int>(cudaGetLastError());
  const long long total = static_cast<long long>(BQ) * kTaps;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cA = static_cast<const float2*>(cenA);
  const float2* cB = static_cast<const float2*>(cenB);
  const float2* gA = static_cast<const float2*>(gridA);
  const float2* gB = static_cast<const float2*>(gridB);
  float* oA = static_cast<float*>(ownA);
  float* xA = static_cast<float*>(crossA);
  float* oB = static_cast<float*>(ownB);
  float* xB = static_cast<float*>(crossB);
  if (vol_bf16) {
    dccl_level_kernel<uint16_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(volA), static_cast<const uint16_t*>(volB),
        cA, cB, gA, gB, oA, xA, oB, xB, BQ, Hl, Wl, Hg, Wg, scale);
  } else {
    dccl_level_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(volA), static_cast<const float*>(volB), cA,
        cB, gA, gB, oA, xA, oB, xB, BQ, Hl, Wl, Hg, Wg, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
