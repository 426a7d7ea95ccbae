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
// Two entries differ only in where the cross tap coords come from:
//   dccl_level_scatter_grid (the backward of the grid route and of the
//     taped step): computed in the kernel, (cx, cy) = sample(grid_other,
//     cen_other[s, b, q]*scale + (i-4, j-4)) by dccl_common.cuh's
//     cross_coord, so it visits exactly the corners the lookup read;
//   dccl_level_scatter (the backward of the planes route): read from given
//     (S, B, Q, 81) coords.
// Every corner rule is the exact transpose of the lookup's sampler
// (dccl_common.cuh::Corners): x wrapped with the divisor's sign, corners
// from floorf, the x+1 corner at column W-1 and an x that wraps to exactly
// W contribute zero, rows outside [0, H-1] contribute zero. (The JAX
// backward clips an x that wraps to W to column W-1, as its Pallas forward
// does; this one follows its own forward so the gradient is exact.) The
// cotangents are a level's column slice of (S, B, Q, L*81) arrays, read at
// a row stride, so no caller copies them.
//
// Bound on the card: bytes. A launch reads g_own and g_cross once (2 x 4 B
// per tap), the centres (8 B per (s, b, q), twice for the grid entry, plus
// the grid) or the given coords (2 x 4 B per tap more), and writes dV once
// in the volume's dtype. One taped step's 8 grid-entry launches (512x1024,
// batch 4, S = 12, bf16) must move 1.05 ms of bytes on an NVIDIA H100 80GB
// HBM3 at 700 W, one standard step's 96 S = 1 launches about 5 ms, nearly
// all of it the dense dV they write (chip_smoke.py phase 7). About 66 f32
// operations per tap, 113 for the grid entry's cross taps.
//
// Design: one block per (b, q) plane, or per row band of it where the f32
// plane exceeds kBandBytes (chosen by shape: 128 KB at level 0 of a
// 1024x2048 input takes two bands; every plane of a 512x1024 input, 32 KB
// at most, takes one). The block zeroes its plane in shared memory, walks
// all S iterations of its query, adds each cotangent times its corner
// weights with shared-memory atomics (corners outside the band are
// skipped), and writes the plane once, in the volume's dtype, with 16-byte
// stores: no global atomics, no zero fill and no cast pass. A shared f32
// atomic add is a compare-and-swap loop on this card (ATOMS.CAST.SPIN in
// the SASS), so the atomics, not the bytes, set the time: each of the own
// window's 9 columns is one work item that merges the two contributions
// consecutive taps make to a shared row (add_own_column: 20 adds instead
// of 36). The cross taps stay single points: the rotation puts their
// corners on no common lattice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dccl_common.cuh"

namespace {

using dccl::kRadius;
using dccl::kTaps;
using dccl::kWin;
constexpr int kThreads = 256;
constexpr int kBandBytes = 64 * 1024;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ void cell_add(float* __restrict__ band, int lo,
                                         int hi, int off, float v) {
  if (off >= lo && off < hi) atomicAdd(band + (off - lo), v);
}

// One point: the transpose of sample_plane at (x, y), cotangent g.
__device__ __forceinline__ void add_point(float* __restrict__ band, int H,
                                          int W, int lo, int hi, float x,
                                          float y, float g) {
  const dccl::Corners c(H, W, x, y);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int off = 0;
      const float wgt = c.at(dx, dy, W, &off);
      if (wgt >= 0.0f) cell_add(band, lo, hi, off, g * wgt);
    }
  }
}

// One own window column (x-offset i-4) of one iteration: the transpose of
// its 9 taps. The column shares its x half (Corners' wrap, floor,
// fraction and column validity); where a tap's top row is the previous
// tap's bottom row (y0 is the previous tap's plus one, checked per tap),
// the two contributions to each of its two cells are summed before one
// atomic add: 20 adds for the column instead of 36.
__device__ __forceinline__ void add_own_column(
    float* __restrict__ band, int H, int W, int lo, int hi, float2 cen,
    float scale, int i, const float* __restrict__ g) {
  const float x = dccl::py_mod(cen.x * scale + static_cast<float>(i - kRadius),
                               static_cast<float>(W));
  const float x0 = floorf(x);
  const float x1 = x0 + 1.0f;
  const float fx = x - x0;
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  const bool ok0 = x0 >= 0.0f && x0 <= xmax;
  const bool ok1 = x1 >= 0.0f && x1 <= xmax;
  const int ix0 = ok0 ? static_cast<int>(x0) : 0;
  const int ix1 = ok1 ? static_cast<int>(x1) : 0;
  const float ys = cen.y * scale;
  float below = __int_as_float(0x7fc00000);  // the pending bottom row
  float b0 = 0.0f, b1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const float gv = __ldg(g + j);
    const float y = ys + static_cast<float>(j - kRadius);
    const float y0 = floorf(y);
    const float fy = y - y0;
    float t0 = gv * ((1.0f - fx) * (1.0f - fy));
    float t1 = gv * (fx * (1.0f - fy));
    if (y0 + 0.0f == below) {
      t0 += b0;
      t1 += b1;
    } else if (below >= 0.0f && below <= ymax) {
      const int row = static_cast<int>(below) * W;
      if (ok0) cell_add(band, lo, hi, row + ix0, b0);
      if (ok1) cell_add(band, lo, hi, row + ix1, b1);
    }
    const float r0 = y0 + 0.0f;
    if (r0 >= 0.0f && r0 <= ymax) {
      const int row = static_cast<int>(r0) * W;
      if (ok0) cell_add(band, lo, hi, row + ix0, t0);
      if (ok1) cell_add(band, lo, hi, row + ix1, t1);
    }
    below = y0 + 1.0f;
    b0 = gv * ((1.0f - fx) * fy);
    b1 = gv * (fx * fy);
  }
  if (below >= 0.0f && below <= ymax) {
    const int row = static_cast<int>(below) * W;
    if (ok0) cell_add(band, lo, hi, row + ix0, b0);
    if (ok1) cell_add(band, lo, hi, row + ix1, b1);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// 16 bytes of output from shared memory: 4 f32 or 8 bf16
__device__ __forceinline__ void store16(float* dst, const float* src, int v) {
  reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(src)[v];
}
__device__ __forceinline__ void store16(uint16_t* dst, const float* src,
                                        int v) {
  const float4 a = reinterpret_cast<const float4*>(src)[2 * v];
  const float4 b = reinterpret_cast<const float4*>(src)[2 * v + 1];
  reinterpret_cast<uint4*>(dst)[v] =
      make_uint4(bf16_pair(a.x, a.y), bf16_pair(a.z, a.w), bf16_pair(b.x, b.y),
                 bf16_pair(b.z, b.w));
}

struct Args {
  const float* g_own;
  long long ld_own;
  const float2* cen;        // (S*BQ) own centres
  const float* g_cross;
  long long ld_cross;
  const float2* cen_other;  // grid entry: the other branch's centres
  const float2* grid;       // grid entry: the other branch's rotation grid
  int Hg, Wg;
  const float* cx;          // given-coords entry: (S*BQ, 81) each
  const float* cy;
  int S;
  long long BQ;
  int Hl, Wl, band_rows;
  float scale;
};

template <bool GRID, typename OutT>
__global__ void __launch_bounds__(kThreads)
    dccl_scatter_kernel(const Args a, OutT* __restrict__ dv) {
  extern __shared__ __align__(16) float acc[];
  const long long bq = blockIdx.x;
  const int r0 = blockIdx.y * a.band_rows;
  const int rows = min(a.band_rows, a.Hl - r0);
  const int lo = r0 * a.Wl;
  const int n = rows * a.Wl;
  for (int v = threadIdx.x; v < n / 4; v += blockDim.x) {
    reinterpret_cast<float4*>(acc)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int e = n / 4 * 4 + threadIdx.x; e < n; e += blockDim.x) acc[e] = 0.0f;
  __syncthreads();

  // per iteration: 9 own columns, then 81 cross taps
  constexpr int kItems = kWin + kTaps;
  const int total = a.S * kItems;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int s = e / kItems;
    const int rem = e - s * kItems;
    const long long row = s * a.BQ + bq;
    if (rem < kWin) {
      add_own_column(acc, a.Hl, a.Wl, lo, lo + n, __ldg(a.cen + row), a.scale,
                     rem, a.g_own + row * a.ld_own + rem * kWin);
    } else {
      const int k = rem - kWin;
      float2 p;
      if (GRID) {
        p = dccl::cross_coord(a.grid, a.Hg, a.Wg, __ldg(a.cen_other + row),
                              a.scale, k);
      } else {
        p = make_float2(__ldg(a.cx + row * kTaps + k),
                        __ldg(a.cy + row * kTaps + k));
      }
      add_point(acc, a.Hl, a.Wl, lo, lo + n, p.x, p.y,
                __ldg(a.g_cross + row * a.ld_cross + k));
    }
  }
  __syncthreads();

  OutT* out = dv + bq * (static_cast<long long>(a.Hl) * a.Wl) + lo;
  constexpr int kVec = 16 / sizeof(OutT);
  if (n % kVec == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int v = threadIdx.x; v < n / kVec; v += blockDim.x) {
      store16(out, acc, v);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) store(out + e, acc[e]);
  }
}

template <bool GRID, typename OutT>
int launch(const Args& a, void* dv, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(a.band_rows) * a.Wl * sizeof(float);
  if (bytes > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dccl_scatter_kernel<GRID, OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(a.BQ),
                  static_cast<unsigned int>((a.Hl + a.band_rows - 1) /
                                            a.band_rows));
  // a warp per 32 of the S x 90 work items or per 512 band elements
  // (zeroed and written 16 bytes a thread), at most kThreads
  const long long work = std::max<long long>(
      static_cast<long long>(a.S) * (kWin + kTaps),
      static_cast<long long>(a.band_rows) * a.Wl / 16);
  const int threads =
      static_cast<int>(std::min<long long>(kThreads, (work + 31) / 32 * 32));
  dccl_scatter_kernel<GRID, OutT><<<grid, threads, bytes, s>>>(
      a, static_cast<OutT*>(dv));
  return static_cast<int>(cudaGetLastError());
}

int run(Args a, void* dv, int dv_bf16, void* stream) {
  if (a.S <= 0 || a.BQ <= 0 || a.Hl <= 0 || a.Wl <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (a.BQ > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int per_row = a.Wl * static_cast<int>(sizeof(float));
  a.band_rows = std::min(a.Hl, std::max(1, kBandBytes / per_row));
  int dev = 0, max_bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (static_cast<long long>(a.band_rows) * per_row > max_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool grid = a.grid != nullptr;
  if (grid && dv_bf16) return launch<true, uint16_t>(a, dv, s);
  if (grid) return launch<true, float>(a, dv, s);
  if (dv_bf16) return launch<false, uint16_t>(a, dv, s);
  return launch<false, float>(a, dv, s);
}

}  // namespace

// Each entry writes every element of `dv` (B*Q planes of Hl x Wl, bf16 when
// dv_bf16 != 0, else f32) on `stream` and returns cudaGetLastError() as an
// int (cudaErrorInvalidValue for a row wider than a block's shared memory).
// g_own, g_cross: S*BQ rows of 81 f32 at row strides ld_own, ld_cross;
// cen, cen_other: (S*BQ, 2) f32.

// Cross tap coords from grid (Hg, Wg, 2) f32 at cen_other.
extern "C" int dccl_level_scatter_grid(const void* g_own, long long ld_own,
                                       const void* cen, const void* g_cross,
                                       long long ld_cross,
                                       const void* cen_other, const void* grid,
                                       int Hg, int Wg, void* dv, int dv_bf16,
                                       int S, long long BQ, int Hl, int Wl,
                                       float scale, void* stream) {
  Args a = {};
  a.g_own = static_cast<const float*>(g_own);
  a.ld_own = ld_own;
  a.cen = static_cast<const float2*>(cen);
  a.g_cross = static_cast<const float*>(g_cross);
  a.ld_cross = ld_cross;
  a.cen_other = static_cast<const float2*>(cen_other);
  a.grid = static_cast<const float2*>(grid);
  a.Hg = Hg;
  a.Wg = Wg;
  a.S = S;
  a.BQ = BQ;
  a.Hl = Hl;
  a.Wl = Wl;
  a.scale = scale;
  return run(a, dv, dv_bf16, stream);
}

// Cross tap coords given: cx, cy (S*BQ, 81) f32.
extern "C" int dccl_level_scatter(const void* g_own, long long ld_own,
                                  const void* cen, const void* g_cross,
                                  long long ld_cross, const void* cx,
                                  const void* cy, void* dv, int dv_bf16, int S,
                                  long long BQ, int Hl, int Wl, float scale,
                                  void* stream) {
  Args a = {};
  a.g_own = static_cast<const float*>(g_own);
  a.ld_own = ld_own;
  a.cen = static_cast<const float2*>(cen);
  a.g_cross = static_cast<const float*>(g_cross);
  a.ld_cross = ld_cross;
  a.cx = static_cast<const float*>(cx);
  a.cy = static_cast<const float*>(cy);
  a.S = S;
  a.BQ = BQ;
  a.Hl = Hl;
  a.Wl = Wl;
  a.scale = scale;
  return run(a, dv, dv_bf16, stream);
}
