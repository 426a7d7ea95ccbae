// DCCL level lookup, both branches: one pyramid level per launch, all
// levels in one launch, or one level at given cross tap coords.
//
// dccl_level_lookup replaces
// prior_flow_tpu/ops/pallas/dccl_gather.py::_dccl_grid_kernel (launched by
// _grid_call). For every query q of the batch and every tap k = i*9 + j of
// the 9x9 window (x-offset i-4, y-offset j-4):
//   own_A[q,k]   = sample(volA[q], c)           c = cenA[q]*scale + (i-4, j-4)
//   cross_A[q,k] = sample(volB[q], sample(gridA, c))
// and the same for branch B with the roles of the volumes swapped. The
// rotation grid is sampled at the level-scaled window coords and its result
// indexes the level volume unscaled: the reference's parity quirk.
//
// dccl_lookup_all_levels replaces _dccl_grid_kernel_all (launched by
// _grid_all_call): the same work for L <= 4 levels in one launch, the level
// on blockIdx.y. Both kernels run one tap body (level_taps below), so the
// all-levels launch gives the bits of L per-level launches.
//
// dccl_level_lookup_coords replaces _dccl_kernel (launched by
// _packed_call_planes): the own taps as above, and the cross taps at given
// coords, cross_A[q,k] = sample(volB[q], (cxA, cyA)[q,k]) and cross_B[q,k] =
// sample(volA[q], (cxB, cyB)[q,k]). With the coords kernel's coords
// (dccl_coords.cu) it gives the bits of dccl_level_lookup.
//
// sample() is the wrap-x bilinear sampler of dccl_common.cuh, which the
// coords and scatter kernels share. The Pallas kernels clip an x that wraps
// to exactly Wl to column Wl-1; these kernels sample zero there, as the
// samplers do. Built with --fmad=false and with the operations in the plain
// version's order, so both round alike.
//
// Bound on the card: bytes. A launch reads each touched 32-byte sector of
// the two volumes (per query, the own 10x10 corner patch and the rotated
// cross patch in each volume: a small part of the 32 KB f32 plane a query
// has at level 0 of a 512x1024 input, 128 KB at 1024x2048) and writes
// 4 x BQ x 81 f32 outputs; the coords variant also reads 4 x BQ x 81 f32
// coords. The arithmetic is about 240 f32 operations per tap.
//
// Design: one thread per (query, tap); the 81 threads of a query share its
// centre load, the output rows are read and written fully coalesced, and
// corners are read through the read-only cache (__ldg). The TPU kernels'
// lane packing, row-select network, bf16 row-pair bitcasts, one-hot strip
// matmul and 128-lane tap padding work around the TPU's lack of gathers;
// Hopper gathers directly, so none of them is carried over, and the grid
// width is not limited to 128 columns. The two (Hg, Wg, 2) grids stay
// resident in L1/L2. Plane offsets are 64-bit (size_t), so a batch whose
// volume exceeds 2^31 elements is addressed correctly. Neighbouring taps
// differ in y, so they stride by Wl: a tap-major reordering is left for a
// later speed pass.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;

// Outputs of one level: four (BQ, 81) f32 arrays.
struct LevelOut {
  float* ownA;
  float* crossA;
  float* ownB;
  float* crossB;
};

// The tap body of one (query, tap) at one level, shared by the per-level
// and the all-levels kernels.
template <typename T>
__device__ __forceinline__ void level_taps(
    const T* __restrict__ volA, const T* __restrict__ volB, float2 ca,
    float2 cb, const float2* __restrict__ gridA,
    const float2* __restrict__ gridB, LevelOut out, long long t, int q, int k,
    int Hl, int Wl, int Hg, int Wg, float scale) {
  const size_t plane = static_cast<size_t>(Hl) * Wl;
  const T* vA = volA + static_cast<size_t>(q) * plane;
  const T* vB = volB + static_cast<size_t>(q) * plane;

  // branch A: own window in volume A, cross taps through grid A into B
  const float2 a = dccl::window_coord(ca, scale, k);
  out.ownA[t] = dccl::sample_plane(vA, Hl, Wl, a.x, a.y);
  const float2 pa = dccl::cross_coord(gridA, Hg, Wg, ca, scale, k);
  out.crossA[t] = dccl::sample_plane(vB, Hl, Wl, pa.x, pa.y);

  // branch B: own window in volume B, cross taps through grid B into A
  const float2 b = dccl::window_coord(cb, scale, k);
  out.ownB[t] = dccl::sample_plane(vB, Hl, Wl, b.x, b.y);
  const float2 pb = dccl::cross_coord(gridB, Hg, Wg, cb, scale, k);
  out.crossB[t] = dccl::sample_plane(vA, Hl, Wl, pb.x, pb.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dccl_level_kernel(const T* __restrict__ volA, const T* __restrict__ volB,
                      const float2* __restrict__ cenA,
                      const float2* __restrict__ cenB,
                      const float2* __restrict__ gridA,
                      const float2* __restrict__ gridB, LevelOut out, int BQ,
                      int Hl, int Wl, int Hg, int Wg, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(BQ) * kTaps) return;
  const int q = static_cast<int>(t / kTaps);
  const int k = static_cast<int>(t - static_cast<long long>(q) * kTaps);
  level_taps(volA, volB, __ldg(cenA + q), __ldg(cenB + q), gridA, gridB, out,
             t, q, k, Hl, Wl, Hg, Wg, scale);
}

// Level descriptors of the all-levels launch, passed by value.
struct AllLevels {
  const void* volA[kMaxLevels];
  const void* volB[kMaxLevels];
  LevelOut out[kMaxLevels];
  int Hl[kMaxLevels];
  int Wl[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dccl_all_levels_kernel(const AllLevels lv,
                           const float2* __restrict__ cenA,
                           const float2* __restrict__ cenB,
                           const float2* __restrict__ gridA,
                           const float2* __restrict__ gridB, int BQ, int Hg,
                           int Wg) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(BQ) * kTaps) return;
  const int l = blockIdx.y;
  const int q = static_cast<int>(t / kTaps);
  const int k = static_cast<int>(t - static_cast<long long>(q) * kTaps);
  level_taps(static_cast<const T*>(lv.volA[l]),
             static_cast<const T*>(lv.volB[l]), __ldg(cenA + q),
             __ldg(cenB + q), gridA, gridB, lv.out[l], t, q, k, lv.Hl[l],
             lv.Wl[l], Hg, Wg, lv.scale[l]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dccl_coords_lookup_kernel(const T* __restrict__ volA,
                              const T* __restrict__ volB,
                              const float2* __restrict__ cenA,
                              const float2* __restrict__ cenB,
                              const float* __restrict__ cxA,
                              const float* __restrict__ cyA,
                              const float* __restrict__ cxB,
                              const float* __restrict__ cyB, LevelOut out,
                              int BQ, int Hl, int Wl, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(BQ) * kTaps) return;
  const int q = static_cast<int>(t / kTaps);
  const int k = static_cast<int>(t - static_cast<long long>(q) * kTaps);
  const size_t plane = static_cast<size_t>(Hl) * Wl;
  const T* vA = volA + static_cast<size_t>(q) * plane;
  const T* vB = volB + static_cast<size_t>(q) * plane;

  // own windows as in level_taps; cross taps at the given coords, branch
  // A's in volume B and branch B's in volume A
  const float2 a = dccl::window_coord(__ldg(cenA + q), scale, k);
  out.ownA[t] = dccl::sample_plane(vA, Hl, Wl, a.x, a.y);
  out.crossA[t] = dccl::sample_plane(vB, Hl, Wl, __ldg(cxA + t), __ldg(cyA + t));
  const float2 b = dccl::window_coord(__ldg(cenB + q), scale, k);
  out.ownB[t] = dccl::sample_plane(vB, Hl, Wl, b.x, b.y);
  out.crossB[t] = dccl::sample_plane(vA, Hl, Wl, __ldg(cxB + t), __ldg(cyB + t));
}

unsigned int blocks_for(int BQ) {
  const long long total = static_cast<long long>(BQ) * kTaps;
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

LevelOut level_out(void* ownA, void* crossA, void* ownB, void* crossB) {
  return LevelOut{static_cast<float*>(ownA), static_cast<float*>(crossA),
                  static_cast<float*>(ownB), static_cast<float*>(crossB)};
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int.
// vol_bf16 != 0 selects bf16 volumes (raw 16-bit words), else f32.

// One level, cross tap coords from the grids.
extern "C" int dccl_level_lookup(const void* volA, const void* volB,
                                 int vol_bf16, const void* cenA,
                                 const void* cenB, const void* gridA,
                                 const void* gridB, void* ownA, void* crossA,
                                 void* ownB, void* crossB, int BQ, int Hl,
                                 int Wl, int Hg, int Wg, float scale,
                                 void* stream) {
  if (BQ <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cA = static_cast<const float2*>(cenA);
  const float2* cB = static_cast<const float2*>(cenB);
  const float2* gA = static_cast<const float2*>(gridA);
  const float2* gB = static_cast<const float2*>(gridB);
  const LevelOut out = level_out(ownA, crossA, ownB, crossB);
  if (vol_bf16) {
    dccl_level_kernel<uint16_t><<<blocks_for(BQ), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(volA), static_cast<const uint16_t*>(volB),
        cA, cB, gA, gB, out, BQ, Hl, Wl, Hg, Wg, scale);
  } else {
    dccl_level_kernel<float><<<blocks_for(BQ), kThreads, 0, s>>>(
        static_cast<const float*>(volA), static_cast<const float*>(volB), cA,
        cB, gA, gB, out, BQ, Hl, Wl, Hg, Wg, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// L levels in one launch. volA, volB: L pointers each; outs: 4L pointers
// ordered (ownA, crossA, ownB, crossB) per level; Hl, Wl, scale: L each.
extern "C" int dccl_lookup_all_levels(int L, const void* const* volA,
                                      const void* const* volB, int vol_bf16,
                                      const void* cenA, const void* cenB,
                                      const void* gridA, const void* gridB,
                                      void* const* outs, int BQ, const int* Hl,
                                      const int* Wl, const float* scale,
                                      int Hg, int Wg, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (BQ <= 0) return static_cast<int>(cudaGetLastError());
  AllLevels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.volA[l] = volA[l];
    lv.volB[l] = volB[l];
    lv.out[l] = level_out(outs[4 * l], outs[4 * l + 1], outs[4 * l + 2],
                          outs[4 * l + 3]);
    lv.Hl[l] = Hl[l];
    lv.Wl[l] = Wl[l];
    lv.scale[l] = scale[l];
  }
  const dim3 grid(blocks_for(BQ), static_cast<unsigned int>(L));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cA = static_cast<const float2*>(cenA);
  const float2* cB = static_cast<const float2*>(cenB);
  const float2* gA = static_cast<const float2*>(gridA);
  const float2* gB = static_cast<const float2*>(gridB);
  if (vol_bf16) {
    dccl_all_levels_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        lv, cA, cB, gA, gB, BQ, Hg, Wg);
  } else {
    dccl_all_levels_kernel<float><<<grid, kThreads, 0, s>>>(lv, cA, cB, gA, gB,
                                                             BQ, Hg, Wg);
  }
  return static_cast<int>(cudaGetLastError());
}

// One level, cross tap coords given: cxA..cyB are (BQ, 81) f32.
extern "C" int dccl_level_lookup_coords(
    const void* volA, const void* volB, int vol_bf16, const void* cenA,
    const void* cenB, const void* cxA, const void* cyA, const void* cxB,
    const void* cyB, void* ownA, void* crossA, void* ownB, void* crossB,
    int BQ, int Hl, int Wl, float scale, void* stream) {
  if (BQ <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cA = static_cast<const float2*>(cenA);
  const float2* cB = static_cast<const float2*>(cenB);
  const float* xA = static_cast<const float*>(cxA);
  const float* yA = static_cast<const float*>(cyA);
  const float* xB = static_cast<const float*>(cxB);
  const float* yB = static_cast<const float*>(cyB);
  const LevelOut out = level_out(ownA, crossA, ownB, crossB);
  if (vol_bf16) {
    dccl_coords_lookup_kernel<uint16_t><<<blocks_for(BQ), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(volA), static_cast<const uint16_t*>(volB),
        cA, cB, xA, yA, xB, yB, out, BQ, Hl, Wl, scale);
  } else {
    dccl_coords_lookup_kernel<float><<<blocks_for(BQ), kThreads, 0, s>>>(
        static_cast<const float*>(volA), static_cast<const float*>(volB), cA,
        cB, xA, yA, xB, yB, out, BQ, Hl, Wl, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
