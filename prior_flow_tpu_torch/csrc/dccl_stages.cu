// The DCCL level lookup's own and cross stages, each run alone.
//
// Replaces tools/microbench_kernel_split.py::_own_only_kernel and
// _cross_only_kernel (launched by _variant_call): kernel 1 (dccl_lookup.cu,
// dccl_level_lookup) with all but one stage left out, both branches, one
// pyramid level, so that their times say which stage sets a level's cost.
// For every query q and tap k = i*9 + j:
//   OWN:   ownA[q,k] = sample(volA[q], cA), ownB[q,k] = sample(volB[q], cB)
//          with c = cen[q]*scale + (i-4, j-4)
//   CROSS: crossA[q,k] = sample(volB[q], sample(gridA, cA)) and
//          crossB[q,k] = sample(volA[q], sample(gridB, cB))
// The third stage, the grid window alone (_gridwin_only_kernel), is the pair
// kernel of gridwin_variants.cu. Each stage calls dccl_common.cuh in the
// order of level_taps (dccl_lookup.cu), under the same --fmad=false build:
// OWN and CROSS give kernel 1's own and cross outputs bit for bit.
//
// Bound on the card: bytes. OWN reads the touched sectors of each query's
// 10x10 own corner patch in both volumes and writes 2 x BQ x 81 f32; CROSS
// reads the rotated cross patches and the grids and writes 2 x BQ x 81 f32.
//
// Design: kernel 1's, one thread per (query, tap), stage chosen at compile
// time; the TPU kernels' packed lanes, row selects and one-hot strip matmul
// are not carried over (see dccl_lookup.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
constexpr int kThreads = 256;

enum Stage : int { kOwn = 0, kCross = 1 };

template <int STAGE, typename T>
__global__ void __launch_bounds__(kThreads)
    dccl_stage_kernel(const T* __restrict__ volA, const T* __restrict__ volB,
                      const float2* __restrict__ cenA,
                      const float2* __restrict__ cenB,
                      const float2* __restrict__ gridA,
                      const float2* __restrict__ gridB, float* __restrict__ o0,
                      float* __restrict__ o1, int BQ, int Hl, int Wl, int Hg,
                      int Wg, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(BQ) * kTaps) return;
  const int q = static_cast<int>(t / kTaps);
  const int k = static_cast<int>(t - static_cast<long long>(q) * kTaps);
  const float2 ca = __ldg(cenA + q);
  const float2 cb = __ldg(cenB + q);

  const size_t plane = static_cast<size_t>(Hl) * Wl;
  const T* vA = volA + static_cast<size_t>(q) * plane;
  const T* vB = volB + static_cast<size_t>(q) * plane;
  if (STAGE == kOwn) {
    const float2 a = dccl::window_coord(ca, scale, k);
    o0[t] = dccl::sample_plane(vA, Hl, Wl, a.x, a.y);
    const float2 b = dccl::window_coord(cb, scale, k);
    o1[t] = dccl::sample_plane(vB, Hl, Wl, b.x, b.y);
  } else {
    const float2 pa = dccl::cross_coord(gridA, Hg, Wg, ca, scale, k);
    o0[t] = dccl::sample_plane(vB, Hl, Wl, pa.x, pa.y);
    const float2 pb = dccl::cross_coord(gridB, Hg, Wg, cb, scale, k);
    o1[t] = dccl::sample_plane(vA, Hl, Wl, pb.x, pb.y);
  }
}

template <int STAGE, typename T>
void launch(const void* volA, const void* volB, const float2* cA,
            const float2* cB, const float2* gA, const float2* gB, float* o0,
            float* o1, int BQ, int Hl, int Wl, int Hg, int Wg, float scale,
            cudaStream_t s) {
  const long long total = static_cast<long long>(BQ) * kTaps;
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  dccl_stage_kernel<STAGE, T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(volA), static_cast<const T*>(volB), cA, cB, gA, gB,
      o0, o1, BQ, Hl, Wl, Hg, Wg, scale);
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() as an int.
// stage 0 own (outputs ownA, ownB), 1 cross (crossA, crossB), each
// (BQ, 81) f32. vol_bf16 != 0 selects bf16 volumes, else f32.
extern "C" int dccl_stage(int stage, const void* volA, const void* volB,
                          int vol_bf16, const void* cenA, const void* cenB,
                          const void* gridA, const void* gridB, void* o0,
                          void* o1, int BQ, int Hl, int Wl, int Hg, int Wg,
                          float scale, void* stream) {
  if (stage != kOwn && stage != kCross) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (BQ <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cA = static_cast<const float2*>(cenA);
  const float2* cB = static_cast<const float2*>(cenB);
  const float2* gA = static_cast<const float2*>(gridA);
  const float2* gB = static_cast<const float2*>(gridB);
  float* p0 = static_cast<float*>(o0);
  float* p1 = static_cast<float*>(o1);
  if (stage == kOwn && vol_bf16) {
    launch<kOwn, uint16_t>(volA, volB, cA, cB, gA, gB, p0, p1, BQ, Hl, Wl, Hg,
                           Wg, scale, s);
  } else if (stage == kOwn) {
    launch<kOwn, float>(volA, volB, cA, cB, gA, gB, p0, p1, BQ, Hl, Wl, Hg, Wg,
                        scale, s);
  } else if (vol_bf16) {
    launch<kCross, uint16_t>(volA, volB, cA, cB, gA, gB, p0, p1, BQ, Hl, Wl,
                             Hg, Wg, scale, s);
  } else {
    launch<kCross, float>(volA, volB, cA, cB, gA, gB, p0, p1, BQ, Hl, Wl, Hg,
                          Wg, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
