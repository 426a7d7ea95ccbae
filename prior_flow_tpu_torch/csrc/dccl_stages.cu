// The DCCL level lookup's stages, each run alone.
//
// Replaces tools/microbench_kernel_split.py::_own_only_kernel,
// _gridwin_only_kernel and _cross_only_kernel (launched by _variant_call):
// kernel 1 (dccl_lookup.cu, dccl_level_lookup) with all but one stage left
// out, both branches, one pyramid level, so that their times say which
// stage sets a level's cost. For every query q and tap k = i*9 + j:
//   OWN:     ownA[q,k] = sample(volA[q], cA), ownB[q,k] = sample(volB[q], cB)
//            with c = cen[q]*scale + (i-4, j-4)
//   GRIDWIN: (xA, yA)[q,k] = sample(gridA, cA), (xB, yB)[q,k] = sample(gridB,
//            cB): the cross tap coords
//   CROSS:   crossA[q,k] = sample(volB[q], sample(gridA, cA)) and
//            crossB[q,k] = sample(volA[q], sample(gridB, cB))
// Each stage is kernel 1's column body (dccl_columns.cuh) with the other
// stages compiled out, under the same --fmad=false build: OWN and CROSS
// give kernel 1's own and cross outputs bit for bit, GRIDWIN the coords
// kernel's coords.
//
// Bound on the card: bytes. OWN reads the touched sectors of each query's
// 10x10 own corner patch in both volumes and writes 2 x BQ x 81 f32;
// GRIDWIN reads the centres and the grids and writes 4 x BQ x 81 f32; CROSS
// reads the rotated cross patches and the grids and writes 2 x BQ x 81 f32.
//
// Design: kernel 1's, one thread per (query, branch, window column), its
// launch shape and register budget; the TPU kernels' packed lanes, row
// selects and one-hot strip matmul are not carried over (see
// dccl_lookup.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_columns.cuh"

namespace {

using dccl::kColBlocksPerSM;
using dccl::kColThreads;
using dccl::kQB;
using dccl::LevelOut;

enum Stage : int { kOwn = 0, kCross = 1, kGridwin = 2 };

template <int STAGES, typename T>
__global__ void __launch_bounds__(kColThreads, kColBlocksPerSM)
    dccl_stage_kernel(const T* __restrict__ volA, const T* __restrict__ volB,
                      const float2* __restrict__ cenA,
                      const float2* __restrict__ cenB,
                      const float2* __restrict__ gridA,
                      const float2* __restrict__ gridB, LevelOut out, int BQ,
                      int Hl, int Wl, int Hg, int Wg, float scale) {
  dccl::level_columns<STAGES>(volA, volB, cenA, cenB, gridA, gridB, out,
                              dccl::kTaps, BQ, Hl, Wl, Hg, Wg, scale);
}

template <int STAGES, typename T>
void launch(const void* volA, const void* volB, const float2* cA,
            const float2* cB, const float2* gA, const float2* gB, LevelOut out,
            int BQ, int Hl, int Wl, int Hg, int Wg, float scale,
            cudaStream_t s) {
  const unsigned int blocks = static_cast<unsigned int>((BQ + kQB - 1) / kQB);
  dccl_stage_kernel<STAGES, T><<<blocks, kColThreads, 0, s>>>(
      static_cast<const T*>(volA), static_cast<const T*>(volB), cA, cB, gA, gB,
      out, BQ, Hl, Wl, Hg, Wg, scale);
}

template <int STAGES>
void launch_dtype(int vol_bf16, const void* volA, const void* volB,
                  const float2* cA, const float2* cB, const float2* gA,
                  const float2* gB, LevelOut out, int BQ, int Hl, int Wl,
                  int Hg, int Wg, float scale, cudaStream_t s) {
  if (vol_bf16) {
    launch<STAGES, uint16_t>(volA, volB, cA, cB, gA, gB, out, BQ, Hl, Wl, Hg,
                             Wg, scale, s);
  } else {
    launch<STAGES, float>(volA, volB, cA, cB, gA, gB, out, BQ, Hl, Wl, Hg, Wg,
                          scale, s);
  }
}

}  // namespace

// Launches one stage on `stream`; returns cudaGetLastError() as an int.
// Outputs, each (BQ, 81) f32: stage 0 own (o0 = ownA, o1 = ownB), 1 cross
// (o0 = crossA, o1 = crossB), 2 gridwin (o0..o3 = xA, yA, xB, yB); o2 and
// o3 are unused by stages 0 and 1. vol_bf16 != 0 selects bf16 volumes,
// else f32.
extern "C" int dccl_stage(int stage, const void* volA, const void* volB,
                          int vol_bf16, const void* cenA, const void* cenB,
                          const void* gridA, const void* gridB, void* o0,
                          void* o1, void* o2, void* o3, int BQ, int Hl, int Wl,
                          int Hg, int Wg, float scale, void* stream) {
  if (stage != kOwn && stage != kCross && stage != kGridwin) {
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
  if (stage == kOwn) {
    launch_dtype<dccl::kOwnTaps>(vol_bf16, volA, volB, cA, cB, gA, gB,
                                 LevelOut{p0, nullptr, p1, nullptr}, BQ, Hl,
                                 Wl, Hg, Wg, scale, s);
  } else if (stage == kCross) {
    launch_dtype<dccl::kGridTaps | dccl::kCrossTaps>(
        vol_bf16, volA, volB, cA, cB, gA, gB,
        LevelOut{nullptr, p0, nullptr, p1}, BQ, Hl, Wl, Hg, Wg, scale, s);
  } else {
    // the grid window reads no volume: one instantiation serves both dtypes
    launch<dccl::kGridTaps, float>(
        volA, volB, cA, cB, gA, gB,
        LevelOut{p0, p1, static_cast<float*>(o2), static_cast<float*>(o3)},
        BQ, Hl, Wl, Hg, Wg, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
