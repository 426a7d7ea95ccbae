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
// sample() is cycle_bilinear_sample (prior_flow_tpu/ops/samplers.py:139):
// x wrapped mod W with the sign of the divisor (fmodf alone is wrong for
// negative x), corners outside [0, W-1] x [0, H-1] give zero, so the x+1
// corner at column W-1 blends toward zero and an x that wraps to exactly W
// samples zero. The Pallas kernel clips that last case to column W-1
// instead; this kernel follows the samplers. Integer corners come from
// floorf, never from a cast (a cast truncates toward zero). Math is f32;
// bf16 corners are upcast exactly. Built with --fmad=false and with the
// operations in the plain version's order, so both round alike.
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

namespace {

constexpr int kRadius = 4;
constexpr int kWin = 2 * kRadius + 1;
constexpr int kTaps = kWin * kWin;
constexpr int kThreads = 256;

__device__ __forceinline__ float py_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((m < 0.0f) != (b < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const uint16_t* p) {
  // bf16 -> f32 is exact: the 16 bits are the high half of the f32 word
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// cycle_bilinear_sample of one query's (H, W) plane at (x_in, y)
template <typename T>
__device__ __forceinline__ float sample_plane(const T* __restrict__ plane,
                                              int H, int W, float x_in,
                                              float y) {
  const float x = py_mod(x_in, static_cast<float>(W));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  float out = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float cx = x0 + static_cast<float>(dx);
      const float cy = y0 + static_cast<float>(dy);
      const float wgt = (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy);
      const bool valid = cx >= 0.0f && cx <= xmax && cy >= 0.0f && cy <= ymax;
      const float v = valid ? load(plane + static_cast<int>(cy) * W +
                                   static_cast<int>(cx))
                            : 0.0f;
      const float term = v * (wgt * (valid ? 1.0f : 0.0f));
      out = (dy == 0 && dx == 0) ? term : out + term;
    }
  }
  return out;
}

// cycle_bilinear_sample of the (Hg, Wg, 2) rotation grid at (x_in, y)
__device__ __forceinline__ float2 sample_grid(const float2* __restrict__ g,
                                              int Hg, int Wg, float x_in,
                                              float y) {
  const float x = py_mod(x_in, static_cast<float>(Wg));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const float xmax = static_cast<float>(Wg - 1);
  const float ymax = static_cast<float>(Hg - 1);
  float2 out = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float cx = x0 + static_cast<float>(dx);
      const float cy = y0 + static_cast<float>(dy);
      const float wgt = (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy);
      const bool valid = cx >= 0.0f && cx <= xmax && cy >= 0.0f && cy <= ymax;
      const float2 v =
          valid ? __ldg(g + static_cast<int>(cy) * Wg + static_cast<int>(cx))
                : make_float2(0.0f, 0.0f);
      const float w = wgt * (valid ? 1.0f : 0.0f);
      const float tx = v.x * w;
      const float ty = v.y * w;
      if (dy == 0 && dx == 0) {
        out = make_float2(tx, ty);
      } else {
        out.x = out.x + tx;
        out.y = out.y + ty;
      }
    }
  }
  return out;
}

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
  const float ox = static_cast<float>(k / kWin - kRadius);
  const float oy = static_cast<float>(k % kWin - kRadius);
  const size_t plane = static_cast<size_t>(Hl) * Wl;
  const T* vA = volA + static_cast<size_t>(q) * plane;
  const T* vB = volB + static_cast<size_t>(q) * plane;

  // branch A: own window in volume A, cross taps through grid A into B
  const float2 ca = __ldg(cenA + q);
  const float ax = ca.x * scale + ox;
  const float ay = ca.y * scale + oy;
  ownA[t] = sample_plane(vA, Hl, Wl, ax, ay);
  const float2 pa = sample_grid(gridA, Hg, Wg, ax, ay);
  crossA[t] = sample_plane(vB, Hl, Wl, pa.x, pa.y);

  // branch B: own window in volume B, cross taps through grid B into A
  const float2 cb = __ldg(cenB + q);
  const float bx = cb.x * scale + ox;
  const float by = cb.y * scale + oy;
  ownB[t] = sample_plane(vB, Hl, Wl, bx, by);
  const float2 pb = sample_grid(gridB, Hg, Wg, bx, by);
  crossB[t] = sample_plane(vA, Hl, Wl, pb.x, pb.y);
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
