// Variants of the DCCL grid-window stage: the cross tap coords of both
// rotation grids at one centre set, (cAx, cAy)[n,k] = sample(gridA,
// cen[n]*scale + (i-4, j-4)) and (cBx, cBy)[n,k] from gridB, tap
// k = i*9 + j.
//
// gridwin_variant replaces tools/microbench_gridwin.py::_variant_kernel
// (launched by variant_call). Every variant runs the column body of kernel
// 1's grid-window stage (dccl_columns.cuh::column_taps): one thread per
// (centre, branch, window column i), the x half of the corners once per
// column, 10 row pairs of grid cells per column instead of 9 x 4 corners,
// the coords staged in shared memory and stored as whole rows (store_run).
// Variants:
//   0 direct:    the grids read through the read-only cache: the coords
//                kernel's both-branch entry (dccl_coords.cu
//                dccl_cross_coords) with the one centre set for both
//                branches, which the wrapper launches; no kernel here;
//   1 smem_grid: both (Hg, Wg, 2) grids staged in shared memory by
//                persistent blocks, which then loop over the centres:
//                blocks of 576 threads (32 centres x 2 branches x 9
//                columns), one per SM at 64x128 grids (128 KB of grids
//                and a 41.5 KB output stage, 169.5 KB of the SM's 228 KB),
//                so the staging is paid once per block; grids that do not
//                fit beside the stage are refused;
//   2 reads:     diagnostic, the column's row-pair reads alone: the 10 row
//                pairs at integer-only addresses (x wrapped, y clamped),
//                tap j the unweighted sum of its two rows' pairs;
//   3 arith:     diagnostic, the column's corner arithmetic alone:
//                column_taps on a reader that returns (1, offset) and
//                reads nothing, so tap j gives (the sum of its valid
//                corners' weights, the sum of weight x offset).
// The diagnostics run the coords kernel's block (16 centres x 2 branches x
// 9 columns, 288 threads) and stage and store their outputs as it does, so
// their times split the column body's. The semantic variants (0, 1) run
// dccl_common.cuh's arithmetic in the coords kernel's order under its
// --fmad=false build, so they give its bits; the diagnostics compute no
// coords. Both branches at their own centres
// (tools/microbench_gridwin.py::_pair_kernel) are the same entry as direct.
//
// Bound on the card: bytes. A launch reads N centres and the two grids
// and writes 4 x N x 81 f32; about 31 f32 operations per tap (the x half
// shared by 9 taps).
//
// Design: the TPU variants (hoisted blends, masked dots, stacked planes,
// pre-blended rows) reorder a one-hot strip matmul and lane gathers that
// Hopper does not need, and its lane packing does not carry over; what
// stays open on Hopper is where the grid is read from: the read-only cache
// (direct) or shared memory (smem_grid).

#include <cuda_runtime.h>

#include "dccl_columns.cuh"
#include "dccl_common.cuh"

namespace {

using dccl::kRadius;
using dccl::kTaps;
using dccl::kWin;

constexpr int kDiagQB = 16;   // centres per diagnostic block
constexpr int kDiagThreads = kDiagQB * 2 * kWin;
constexpr int kSmemQB = 32;   // centres per step of a smem_grid block
constexpr int kSmemThreads = kSmemQB * 2 * kWin;

enum Variant : int { kDirect = 0, kSmemGrid = 1, kReads = 2, kArith = 3 };

// x A, y A, x B, y B: (N, 81) f32 each
struct Out {
  float* xy[4];
};

// Grid cell `off` from a copy of the grid in shared memory.
struct SharedGrid {
  const float2* g;
  __device__ __forceinline__ float2 operator()(int off) const { return g[off]; }
};

// Reads nothing: cell `off` is (1, off), so that a sampler's sum is (the
// sum of its valid corners' weights, the sum of weight x offset).
struct NoRead {
  const float2* g;  // unused
  __device__ __forceinline__ float2 operator()(int off) const {
    return make_float2(1.0f, static_cast<float>(off));
  }
};

// The row pairs of window column i around the centre's integer cell,
// wrapped in x and clamped in y with integer arithmetic only; tap j is the
// unweighted sum of rows j and j + 1.
__device__ __forceinline__ void column_reads(const float2* __restrict__ g,
                                             int Hg, int Wg, float2 cen,
                                             float scale, int i, float* sx,
                                             float* sy) {
  const int x0 = __float2int_rd(cen.x * scale) + i - kRadius;
  const int xa = ((x0 % Wg) + Wg) % Wg;
  const int xb = xa + 1 < Wg ? xa + 1 : Wg - 1;
  const int y0 = __float2int_rd(cen.y * scale) - kRadius;
  float2 prev = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j <= kWin; ++j) {
    const int y = min(max(y0 + j, 0), Hg - 1);
    const float2 a = __ldg(g + y * Wg + xa);
    const float2 b = __ldg(g + y * Wg + xb);
    const float2 row = make_float2(a.x + b.x, a.y + b.y);
    if (j > 0) {
      sx[j - 1] = prev.x + row.x;
      sy[j - 1] = prev.y + row.y;
    }
    prev = row;
  }
}

// What one thread computes for its (branch, centre, column): the column
// body on grids read by Fetch, or the reads diagnostic.
template <class Fetch, bool READS = false>
struct Column {
  const float2* cen;
  const float2* gA;
  const float2* gB;
  int Hg, Wg;
  float scale;

  __device__ __forceinline__ void operator()(int br, long long q, int i,
                                             float* sx, float* sy) const {
    const float2 c = __ldg(cen + q);
    if constexpr (READS) {
      column_reads(br ? gB : gA, Hg, Wg, c, scale, i, sx, sy);
    } else {
      dccl::column_taps<dccl::kGridTaps, float, Fetch>(
          nullptr, nullptr, c, br ? gB : gA, i, 0, 0, Hg, Wg, scale, sx, sy);
    }
  }
};

// Centres q0 .. q0 + QB - 1, both branches, one thread per (branch,
// centre, column): `col` writes the column's 9 x and 9 y into the stage
// (4 arrays of QB x 81 floats, 16-byte aligned), then the block stores
// the stage as whole rows.
template <int QB, class Col>
__device__ __forceinline__ void column_step(const Col& col, float* stage,
                                            const Out& out, long long q0,
                                            long long N) {
  constexpr int kThreads = QB * 2 * kWin;
  const int tid = threadIdx.x;
  const int br = tid / (QB * kWin);
  const int r = tid - br * QB * kWin;
  const int ql = r / kWin;
  const int i = r - ql * kWin;
  const long long q = q0 + ql;
  if (q < N) {
    const int at = ql * kTaps + i * kWin;   // stride 9 across threads
    col(br, q, i, stage + 2 * br * QB * kTaps + at,
        stage + (2 * br + 1) * QB * kTaps + at);
  }
  __syncthreads();
  const long long left = N - q0;
  const int n = (left < QB ? static_cast<int>(left) : QB) * kTaps;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dccl::store_run<kThreads>(out.xy[a] + q0 * kTaps, stage + a * QB * kTaps,
                              n, tid);
  }
}

__global__ void __launch_bounds__(kSmemThreads, 1)
    gridwin_smem_kernel(const float2* __restrict__ cen,
                        const float2* __restrict__ gridA,
                        const float2* __restrict__ gridB, Out out, long long N,
                        int Hg, int Wg, float scale) {
  extern __shared__ __align__(16) float2 sgrid[];
  const int cells = Hg * Wg;
  for (int e = threadIdx.x; e < cells; e += kSmemThreads) {
    sgrid[e] = __ldg(gridA + e);
    sgrid[cells + e] = __ldg(gridB + e);
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(sgrid + 2 * cells);
  const Column<SharedGrid> col{cen, sgrid, sgrid + cells, Hg, Wg, scale};
  for (long long q0 = static_cast<long long>(blockIdx.x) * kSmemQB; q0 < N;
       q0 += static_cast<long long>(gridDim.x) * kSmemQB) {
    column_step<kSmemQB>(col, stage, out, q0, N);
    __syncthreads();   // the stage is read before the next step writes it
  }
}

template <int VARIANT>
__global__ void __launch_bounds__(kDiagThreads, 5)
    gridwin_diag_kernel(const float2* __restrict__ cen,
                        const float2* __restrict__ gridA,
                        const float2* __restrict__ gridB, Out out, long long N,
                        int Hg, int Wg, float scale) {
  __shared__ __align__(16) float stage[4 * kDiagQB * kTaps];
  const long long q0 = static_cast<long long>(blockIdx.x) * kDiagQB;
  if (VARIANT == kReads) {
    const Column<dccl::GlobalGrid, true> col{cen, gridA, gridB, Hg, Wg, scale};
    column_step<kDiagQB>(col, stage, out, q0, N);
  } else {
    const Column<NoRead> col{cen, gridA, gridB, Hg, Wg, scale};
    column_step<kDiagQB>(col, stage, out, q0, N);
  }
}

size_t smem_bytes(int Hg, int Wg) {
  return 2 * static_cast<size_t>(Hg) * Wg * sizeof(float2) +
         4 * static_cast<size_t>(kSmemQB) * kTaps * sizeof(float);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for direct, which is dccl_cross_coords, for an
// unknown variant, or, for smem_grid, grids that do not fit in one block's
// shared memory beside the stage). cen: (N, 2) f32; gridA, gridB:
// (Hg, Wg, 2) f32; ax..by: (N, 81) f32.
extern "C" int gridwin_variant(int variant, const void* cen, const void* gridA,
                               const void* gridB, void* ax, void* ay, void* bx,
                               void* by, long long N, int Hg, int Wg,
                               float scale, void* stream) {
  if (variant <= kDirect || variant > kArith) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* c = static_cast<const float2*>(cen);
  const float2* gA = static_cast<const float2*>(gridA);
  const float2* gB = static_cast<const float2*>(gridB);
  const Out out = {{static_cast<float*>(ax), static_cast<float*>(ay),
                    static_cast<float*>(bx), static_cast<float*>(by)}};
  if (variant == kSmemGrid) {
    const size_t bytes = smem_bytes(Hg, Wg);
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
    const long long needed = (N + kSmemQB - 1) / kSmemQB;
    long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    if (blocks > needed) blocks = needed;
    gridwin_smem_kernel<<<static_cast<unsigned int>(blocks), kSmemThreads,
                          bytes, s>>>(c, gA, gB, out, N, Hg, Wg, scale);
  } else {
    const unsigned int blocks =
        static_cast<unsigned int>((N + kDiagQB - 1) / kDiagQB);
    if (variant == kReads) {
      gridwin_diag_kernel<kReads><<<blocks, kDiagThreads, 0, s>>>(
          c, gA, gB, out, N, Hg, Wg, scale);
    } else {
      gridwin_diag_kernel<kArith><<<blocks, kDiagThreads, 0, s>>>(
          c, gA, gB, out, N, Hg, Wg, scale);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
