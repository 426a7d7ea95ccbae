// Shared device code of the DCCL kernels: the wrap-x bilinear sampler of a
// level plane, the sampler of the 1/8 rotation grid, the 9x9 window coords
// of one tap, and the sampler of one window column (ColumnSampler: the
// same arithmetic with the column's shared x half taken once, which the
// lookup's column body runs).
//
// dccl_lookup.cu (the lookup), dccl_coords.cu (the cross tap coords alone),
// dccl_scatter.cu (the lookup's transpose), dccl_stages.cu (the lookup's
// stages one at a time; the column body of the lookup and its stages is
// dccl_columns.cuh) and gridwin_variants.cu (the grid-window stage's
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
// py_mod takes fmodf only outside (-W, 2W): every tap of a window whose
// centre lies on or near the image wraps by one add or none, in fmodf's
// bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dccl {

constexpr int kRadius = 4;
constexpr int kWin = 2 * kRadius + 1;
constexpr int kTaps = kWin * kWin;

// a mod b with the sign of b, for b > 0 (every caller passes a width).
// Inside (-b, 2b) three exact cases give fmodf's bits without it: a + b
// for a < 0 (fmodf returns a, the sign fix adds b), a for 0 <= a < b, and
// a - b for b <= a < 2b (exact by Sterbenz, as fmodf's result is). a = -b
// (fmodf gives -0), NaN and everything outside take fmodf.
__device__ __forceinline__ float py_mod(float a, float b) {
  if (a > -b && a < 2.0f * b) {
    return a < 0.0f ? a + b : (a < b ? a : a - b);
  }
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

// Reads element `off` of one query's level plane as f32.
template <typename T>
struct PlaneRead {
  const T* p;
  __device__ __forceinline__ float operator()(int off) const {
    return load(p + off);
  }
};

__device__ __forceinline__ float scaled(float v, float w) { return v * w; }
__device__ __forceinline__ float2 scaled(float2 v, float w) {
  return make_float2(v.x * w, v.y * w);
}
__device__ __forceinline__ float plus(float a, float b) { return a + b; }
__device__ __forceinline__ float2 plus(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// The sampler of one window column: the 9 taps of column i share their x,
// so the x half of Corners (wrap, floor, fraction, column validity) is taken
// once. Each tap then takes its own y half, and where its top row is the
// row below the previous tap's (checked per tap, on the f32 row values), it
// reuses the two values that tap read instead of reading them again. The
// weights, validity rules and summation order are Corners' and
// sample_plane's / sample_grid_from's, so every tap gives their bits: only
// where the values come from changes. V is float (a level plane) or float2
// (the rotation grid); `read(off)` returns the V at flat offset off.
template <typename V>
struct ColumnSampler {
  float fx, ymax, below;  // below: the previous tap's bottom row (NaN: none)
  int W, ix0, ix1;
  bool okx0, okx1;
  V b0, b1;               // the previous tap's bottom-row values

  __device__ __forceinline__ ColumnSampler(int H, int W_, float x_in) : W(W_) {
    const float x = py_mod(x_in, static_cast<float>(W));
    const float x0 = floorf(x);
    const float x1 = x0 + 1.0f;
    const float xmax = static_cast<float>(W - 1);
    fx = x - x0;
    ymax = static_cast<float>(H - 1);
    okx0 = x0 >= 0.0f && x0 <= xmax;
    okx1 = x1 >= 0.0f && x1 <= xmax;
    ix0 = okx0 ? static_cast<int>(x0) : 0;
    ix1 = okx1 ? static_cast<int>(x1) : 0;
    below = __int_as_float(0x7fc00000);
    b0 = V{};
    b1 = V{};
  }

  template <class Read>
  __device__ __forceinline__ V tap(const Read& read, float y) {
    const float y0 = floorf(y);
    const float fy = y - y0;
    const float r0 = y0 + 0.0f;
    const float r1 = y0 + 1.0f;
    const bool ok0 = r0 >= 0.0f && r0 <= ymax;
    const bool ok1 = r1 >= 0.0f && r1 <= ymax;
    V t0, t1;
    if (r0 == below) {  // y0 is the previous tap's plus one: its bottom row
      t0 = b0;
      t1 = b1;
    } else {
      const int row = ok0 ? static_cast<int>(r0) * W : 0;
      t0 = ok0 && okx0 ? read(row + ix0) : V{};
      t1 = ok0 && okx1 ? read(row + ix1) : V{};
    }
    const int row1 = ok1 ? static_cast<int>(r1) * W : 0;
    b0 = ok1 && okx0 ? read(row1 + ix0) : V{};
    b1 = ok1 && okx1 ? read(row1 + ix1) : V{};
    below = r1;
    // corners (dy, dx) = 00, 01, 10, 11 in Corners::at's weights and order
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    V out = ok0 && okx0 ? scaled(t0, gx * gy) : V{};
    out = plus(out, ok0 && okx1 ? scaled(t1, fx * gy) : V{});
    out = plus(out, ok1 && okx0 ? scaled(b0, gx * fy) : V{});
    out = plus(out, ok1 && okx1 ? scaled(b1, fx * fy) : V{});
    return out;
  }
};

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
