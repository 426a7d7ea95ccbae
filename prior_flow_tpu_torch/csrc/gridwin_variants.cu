// Variants of the DCCL grid-window stage: the cross tap coords of both
// rotation grids at one centre set, (cAx, cAy)[n,k] = sample(gridA,
// cen[n]*scale + (i-4, j-4)) and (cBx, cBy)[n,k] from gridB, tap
// k = i*9 + j.
//
// gridwin_variant replaces tools/microbench_gridwin.py::_variant_kernel
// (launched by variant_call). Variants:
//   0 direct:    one thread per (centre, tap), dccl::cross_coord on both
//                grids, the grid read through the read-only cache;
//   1 smem_grid: both (Hg, Wg, 2) grids staged in shared memory (128 KB for
//                the 64x128 grids of a 512x1024 input), persistent blocks
//                that loop over the taps, so the staging is paid once per
//                block; grids that do not fit are refused;
//   2 reads:     diagnostic, the grid reads alone: each tap's four corner
//                cells at integer-only addresses, summed unweighted;
//   3 arith:     diagnostic, the corner arithmetic alone: window, wrap,
//                floors, validity and weights as dccl::Corners does them,
//                summed without reading the grid.
// The semantic variants (0, 1) call dccl_common.cuh in the coords kernel's
// order under its --fmad=false build, so they give its bits; the
// diagnostics compute no coords. Both branches at their own centres
// (tools/microbench_gridwin.py::_pair_kernel) are the coords kernel's
// both-branch entry (dccl_coords.cu), whose column body the variants are
// timed against.
//
// Bound on the card: bytes. A launch reads N centres and the two grids
// and writes 4 x N x 81 f32; about 100 f32 operations per tap.
//
// Design: the TPU variants (hoisted blends, masked dots, stacked planes,
// pre-blended rows) reorder a one-hot strip matmul and lane gathers that
// Hopper does not need; what stays open on Hopper is where the grid is read
// from: the read-only cache (direct) or shared memory (smem_grid).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dccl_common.cuh"

namespace {

using dccl::kTaps;
constexpr int kThreads = 256;
constexpr int kSmemThreads = 1024;

enum Variant : int { kDirect = 0, kSmemGrid = 1, kReads = 2, kArith = 3 };

struct Out {
  float* ax;
  float* ay;
  float* bx;
  float* by;
};

struct SharedGrid {
  const float2* g;
  __device__ __forceinline__ float2 operator()(int off) const { return g[off]; }
};

__device__ __forceinline__ void tap_of(long long t, long long* n, int* k) {
  *n = t / kTaps;
  *k = static_cast<int>(t - *n * kTaps);
}

__global__ void __launch_bounds__(kThreads)
    gridwin_direct_kernel(const float2* __restrict__ cenA,
                          const float2* __restrict__ cenB,
                          const float2* __restrict__ gridA,
                          const float2* __restrict__ gridB, Out out,
                          long long N, int Hg, int Wg, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= N * kTaps) return;
  long long n;
  int k;
  tap_of(t, &n, &k);
  const float2 pa = dccl::cross_coord(gridA, Hg, Wg, __ldg(cenA + n), scale, k);
  out.ax[t] = pa.x;
  out.ay[t] = pa.y;
  const float2 pb = dccl::cross_coord(gridB, Hg, Wg, __ldg(cenB + n), scale, k);
  out.bx[t] = pb.x;
  out.by[t] = pb.y;
}

__global__ void __launch_bounds__(kSmemThreads)
    gridwin_smem_kernel(const float2* __restrict__ cenA,
                        const float2* __restrict__ cenB,
                        const float2* __restrict__ gridA,
                        const float2* __restrict__ gridB, Out out, long long N,
                        int Hg, int Wg, float scale) {
  extern __shared__ float2 sgrid[];
  const int cells = Hg * Wg;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    sgrid[i] = __ldg(gridA + i);
    sgrid[cells + i] = __ldg(gridB + i);
  }
  __syncthreads();
  const SharedGrid sA{sgrid};
  const SharedGrid sB{sgrid + cells};
  const long long total = N * kTaps;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    long long n;
    int k;
    tap_of(t, &n, &k);
    const float2 pa =
        dccl::cross_coord_from(sA, Hg, Wg, __ldg(cenA + n), scale, k);
    out.ax[t] = pa.x;
    out.ay[t] = pa.y;
    const float2 pb =
        dccl::cross_coord_from(sB, Hg, Wg, __ldg(cenB + n), scale, k);
    out.bx[t] = pb.x;
    out.by[t] = pb.y;
  }
}

// The four corner cells of tap k around the centre's integer cell, wrapped
// in x and clamped in y with integer arithmetic only, summed unweighted.
__device__ __forceinline__ float2 corner_reads(const float2* __restrict__ g,
                                               int Hg, int Wg, float2 cen,
                                               float scale, int k) {
  const int x0 = __float2int_rd(cen.x * scale) + k / dccl::kWin - dccl::kRadius;
  const int y0 = __float2int_rd(cen.y * scale) + k % dccl::kWin - dccl::kRadius;
  const int xa = ((x0 % Wg) + Wg) % Wg;
  const int xb = xa + 1 < Wg ? xa + 1 : Wg - 1;
  const int ya = y0 < 0 ? 0 : (y0 > Hg - 1 ? Hg - 1 : y0);
  const int yb = ya + 1 < Hg ? ya + 1 : Hg - 1;
  const float2 v00 = __ldg(g + ya * Wg + xa);
  const float2 v01 = __ldg(g + ya * Wg + xb);
  const float2 v10 = __ldg(g + yb * Wg + xa);
  const float2 v11 = __ldg(g + yb * Wg + xb);
  return make_float2(v00.x + v01.x + v10.x + v11.x,
                     v00.y + v01.y + v10.y + v11.y);
}

// dccl::sample_grid_from's corner arithmetic for tap k, the grid left unread:
// returns (sum of the valid corners' weights, sum of weight * offset).
__device__ __forceinline__ float2 corner_arith(int Hg, int Wg, float2 cen,
                                               float scale, int k) {
  const float2 w = dccl::window_coord(cen, scale, k);
  const dccl::Corners c(Hg, Wg, w.x, w.y);
  float2 out = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int off = 0;
      const float wt = c.at(dx, dy, Wg, &off);
      if (wt >= 0.0f) {
        out.x = out.x + wt;
        out.y = out.y + wt * static_cast<float>(off);
      }
    }
  }
  return out;
}

template <int VARIANT>
__global__ void __launch_bounds__(kThreads)
    gridwin_diag_kernel(const float2* __restrict__ cenA,
                        const float2* __restrict__ cenB,
                        const float2* __restrict__ gridA,
                        const float2* __restrict__ gridB, Out out, long long N,
                        int Hg, int Wg, float scale) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= N * kTaps) return;
  long long n;
  int k;
  tap_of(t, &n, &k);
  const float2 ca = __ldg(cenA + n);
  const float2 cb = __ldg(cenB + n);
  const float2 pa = VARIANT == kReads ? corner_reads(gridA, Hg, Wg, ca, scale, k)
                                      : corner_arith(Hg, Wg, ca, scale, k);
  const float2 pb = VARIANT == kReads ? corner_reads(gridB, Hg, Wg, cb, scale, k)
                                      : corner_arith(Hg, Wg, cb, scale, k);
  out.ax[t] = pa.x;
  out.ay[t] = pa.y;
  out.bx[t] = pb.x;
  out.by[t] = pb.y;
}

unsigned int blocks_for(long long N) {
  return static_cast<unsigned int>((N * kTaps + kThreads - 1) / kThreads);
}

Out out_of(void* ax, void* ay, void* bx, void* by) {
  return Out{static_cast<float*>(ax), static_cast<float*>(ay),
             static_cast<float*>(bx), static_cast<float*>(by)};
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for an unknown variant or, for smem_grid, grids
// that do not fit in one block's shared memory). cenA, cenB: (N, 2) f32;
// gridA, gridB: (Hg, Wg, 2) f32; ax..by: (N, 81) f32.
extern "C" int gridwin_variant(int variant, const void* cenA, const void* cenB,
                               const void* gridA, const void* gridB, void* ax,
                               void* ay, void* bx, void* by, long long N,
                               int Hg, int Wg, float scale, void* stream) {
  if (variant < kDirect || variant > kArith) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cA = static_cast<const float2*>(cenA);
  const float2* cB = static_cast<const float2*>(cenB);
  const float2* gA = static_cast<const float2*>(gridA);
  const float2* gB = static_cast<const float2*>(gridB);
  const Out out = out_of(ax, ay, bx, by);
  if (variant == kDirect) {
    gridwin_direct_kernel<<<blocks_for(N), kThreads, 0, s>>>(
        cA, cB, gA, gB, out, N, Hg, Wg, scale);
  } else if (variant == kSmemGrid) {
    const size_t bytes = 2 * static_cast<size_t>(Hg) * Wg * sizeof(float2);
    int dev = 0, max_bytes = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    if (bytes > static_cast<size_t>(max_bytes)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaFuncSetAttribute(gridwin_smem_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gridwin_smem_kernel, kSmemThreads, bytes);
    const long long needed = (N * kTaps + kSmemThreads - 1) / kSmemThreads;
    long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    if (blocks > needed) blocks = needed;
    gridwin_smem_kernel<<<static_cast<unsigned int>(blocks), kSmemThreads,
                          bytes, s>>>(cA, cB, gA, gB, out, N, Hg, Wg, scale);
  } else if (variant == kReads) {
    gridwin_diag_kernel<kReads><<<blocks_for(N), kThreads, 0, s>>>(
        cA, cB, gA, gB, out, N, Hg, Wg, scale);
  } else {
    gridwin_diag_kernel<kArith><<<blocks_for(N), kThreads, 0, s>>>(
        cA, cB, gA, gB, out, N, Hg, Wg, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
