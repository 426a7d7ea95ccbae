// Shared device code of the DCCL kernels: the wrap-x bilinear sampler of a
// level plane, the sampler of the 1/8 rotation grid, and the 9x9 window
// coords of one tap.
//
// dccl_lookup.cu (the lookup), dccl_coords.cu (the cross tap coords alone),
// dccl_scatter.cu (the lookup's transpose), dccl_stages.cu (the lookup's
// stages one at a time) and gridwin_variants.cu (the grid-window stage's
// variants) all take their window and grid arithmetic from here, and every
// source is built with --fmad=false, so the coords kernel gives the
// lookup's own cross tap coords bit for bit and the scatter visits exactly
// the corners the lookup read.
//
// The sampler is cycle_bilinear_sample (prior_flow_tpu/ops/samplers.py:139):
// x wrapped mod W with the sign of the divisor (fmodf alone is wrong for
// negative x), corners outside [0, W-1] x [0, H-1] give zero, so the x+1
// corner at column W-1 blends toward zero and an x that wraps to exactly W
// samples zero. Integer corners come from floorf, never from a cast (a cast
// truncates toward zero). Math is f32; bf16 values are upcast exactly.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dccl {

constexpr int kRadius = 4;
constexpr int kWin = 2 * kRadius + 1;
constexpr int kTaps = kWin * kWin;

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

// One bilinear corner of the wrap-x sampler at (x_in, y) on an (H, W)
// plane: the corners' integer positions, weights and validity, in the
// order (dy, dx) = 00, 01, 10, 11 that the sampler sums them in.
struct Corners {
  float x0, y0, fx, fy, xmax, ymax;

  __device__ __forceinline__ Corners(int H, int W, float x_in, float y) {
    const float x = py_mod(x_in, static_cast<float>(W));
    x0 = floorf(x);
    y0 = floorf(y);
    fx = x - x0;
    fy = y - y0;
    xmax = static_cast<float>(W - 1);
    ymax = static_cast<float>(H - 1);
  }

  // corner (dx, dy): writes its flat offset and returns its weight, or
  // returns -1 when the corner lies outside the plane
  __device__ __forceinline__ float at(int dx, int dy, int W, int* off) const {
    const float cx = x0 + static_cast<float>(dx);
    const float cy = y0 + static_cast<float>(dy);
    if (!(cx >= 0.0f && cx <= xmax && cy >= 0.0f && cy <= ymax)) return -1.0f;
    *off = static_cast<int>(cy) * W + static_cast<int>(cx);
    return (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy);
  }
};

// cycle_bilinear_sample of one query's (H, W) plane at (x_in, y)
template <typename T>
__device__ __forceinline__ float sample_plane(const T* __restrict__ plane,
                                              int H, int W, float x_in,
                                              float y) {
  const Corners c(H, W, x_in, y);
  float out = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int off = 0;
      const float wgt = c.at(dx, dy, W, &off);
      // an invalid corner adds v * 0 with v = 0, as the plain version does
      const float term = wgt >= 0.0f ? load(plane + off) * wgt : 0.0f * 0.0f;
      out = (dy == 0 && dx == 0) ? term : out + term;
    }
  }
  return out;
}

// Reads cell `off` of a grid in device memory through the read-only cache.
// A kernel that stages the grid in shared memory passes its own reader to
// cross_coord_from below, so its arithmetic stays this header's.
struct GlobalGrid {
  const float2* g;
  __device__ __forceinline__ float2 operator()(int off) const {
    return __ldg(g + off);
  }
};

// cycle_bilinear_sample of the (Hg, Wg, 2) rotation grid at (x_in, y),
// grid cells read by `fetch`
template <class Fetch>
__device__ __forceinline__ float2 sample_grid_from(const Fetch& fetch, int Hg,
                                                   int Wg, float x_in,
                                                   float y) {
  const Corners c(Hg, Wg, x_in, y);
  float2 out = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      int off = 0;
      const float w = c.at(dx, dy, Wg, &off);
      float tx = 0.0f, ty = 0.0f;
      if (w >= 0.0f) {
        const float2 v = fetch(off);
        tx = v.x * w;
        ty = v.y * w;
      }
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

// Own window coords of tap k = i*9 + j (x-offset i-4, y-offset j-4) around
// the level-scaled centre.
__device__ __forceinline__ float2 window_coord(float2 cen, float scale, int k) {
  const float ox = static_cast<float>(k / kWin - kRadius);
  const float oy = static_cast<float>(k % kWin - kRadius);
  return make_float2(cen.x * scale + ox, cen.y * scale + oy);
}

// Cross tap coords of tap k: the rotation grid sampled at the level-scaled
// window coords, used unscaled in the other volume (the reference's
// parity quirk).
template <class Fetch>
__device__ __forceinline__ float2 cross_coord_from(const Fetch& fetch, int Hg,
                                                   int Wg, float2 cen,
                                                   float scale, int k) {
  const float2 w = window_coord(cen, scale, k);
  return sample_grid_from(fetch, Hg, Wg, w.x, w.y);
}

__device__ __forceinline__ float2 cross_coord(const float2* __restrict__ grid,
                                              int Hg, int Wg, float2 cen,
                                              float scale, int k) {
  return cross_coord_from(GlobalGrid{grid}, Hg, Wg, cen, scale, k);
}

}  // namespace dccl
