// DCCL volume scatter: one volume's cotangent at one pyramid level, summed
// over S stacked iterations.
//
// The transpose of the lookup (dccl_lookup.cu) for one volume. In the JAX
// package this is no Pallas kernel but XLA one-hot einsums inside the
// lookup's custom VJPs (prior_flow_tpu/ops/pallas/dccl_gather.py::
// _scatter_own_cross, and the stacked _scatter_grads_window_multi +
// _scatter_grads_multi of the taped backward), shaped so because a TPU has
// no atomics. For every (s, b, q) and tap k = i*9 + j:
//   dV[b, q] += own-window transpose of g_own[s, b, q, k] at
//               cen[s, b, q]*scale + (i-4, j-4)
//             + transpose of g_cross[s, b, q, k] at (cx, cy)[s, b, q, k]
// Every corner rule is the exact transpose of the lookup's sampler
// (dccl_common.cuh::Corners): x wrapped with the divisor's sign, corners
// from floorf, the x+1 corner at column W-1 and an x that wraps to exactly
// W contribute zero, rows outside [0, H-1] contribute zero. (The JAX
// backward clips an x that wraps to W to column W-1, as its Pallas forward
// does; this one follows its own forward so the gradient is exact.)
//
// Bound on the card: bytes. A launch reads g_own, g_cross, cx, cy (4 x 4 B
// per tap) and the centres, and writes dV once in the volume's dtype; the
// f32 accumulator is zeroed and atomically updated in L2. About 60 f32
// operations per tap.
//
// Design: one thread per (s, b, q, tap) adds its cotangent times each of
// its 4 corner weights, own and cross, with f32 atomicAdd into a zeroed f32
// buffer (the wrapper casts it once to bf16 when the volume is bf16). A
// query owns its plane, so atomics contend only among the taps and
// iterations of one query; consecutive threads are the 81 taps of one
// query, so a warp's atomics land in one small patch of one plane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
constexpr int kThreads = 256;

__device__ __forceinline__ void scatter_point(float* __restrict__ plane,
                                              int H, int W, float x, float y,
                                              float g) {
  const dccl::Corners c(H, W, x, y);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int off = 0;
      const float wgt = c.at(dx, dy, W, &off);
      if (wgt >= 0.0f) atomicAdd(plane + off, g * wgt);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dccl_scatter_kernel(const float* __restrict__ g_own,
                        const float* __restrict__ g_cross,
                        const float2* __restrict__ cen,
                        const float* __restrict__ cx,
                        const float* __restrict__ cy, float* __restrict__ dv,
                        long long total, long long BQ, int Hl, int Wl,
                        float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long sq = t / kTaps;          // s * BQ + (b * Q + q)
  const int k = static_cast<int>(t - sq * kTaps);
  const long long q = sq % BQ;
  float* plane = dv + q * (static_cast<long long>(Hl) * Wl);
  const float2 w = dccl::window_coord(__ldg(cen + sq), scale, k);
  scatter_point(plane, Hl, Wl, w.x, w.y, __ldg(g_own + t));
  scatter_point(plane, Hl, Wl, __ldg(cx + t), __ldg(cy + t),
                __ldg(g_cross + t));
}

}  // namespace

// Accumulates into `dv` (B*Q planes of Hl x Wl f32, zeroed by the caller)
// on `stream`; returns cudaGetLastError() as an int.
extern "C" int dccl_level_scatter(const void* g_own, const void* g_cross,
                                  const void* cen, const void* cx,
                                  const void* cy, void* dv, int S,
                                  long long BQ, int Hl, int Wl, float scale,
                                  void* stream) {
  const long long total = static_cast<long long>(S) * BQ * kTaps;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  dccl_scatter_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g_own), static_cast<const float*>(g_cross),
      static_cast<const float2*>(cen), static_cast<const float*>(cx),
      static_cast<const float*>(cy), static_cast<float*>(dv), total, BQ, Hl,
      Wl, scale);
  return static_cast<int>(cudaGetLastError());
}
