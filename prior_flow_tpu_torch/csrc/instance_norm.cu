// Instance-norm statistics: per-row sums of y and x*y, accumulated in f64,
// returned as f32.
//
// Replaces prior_flow_tpu/ops/pallas/instance_norm.py::_sums_kernel
// (launched by _lane_sums). With NCHW activations every (sample, channel)
// pair is one contiguous row of H*W elements; row r gets
//   s1[r] = sum(y[r, :]),  s2[r] = sum(x[r, :] * y[r, :])
// from f32 or bf16 inputs. y = x gives the forward moments; y = dy gives
// the backward's two sums (same contract as the TPU kernel, so the backward
// can reuse it). Each product x*y is exact in f64 and the sums accumulate
// in f64: the feature encoder's weight gradients are sensitive to the
// rounding of these sums (summed in f32 they moved by ~2e-3 relative;
// tests/test_torch_port_train.py::test_encoder_grads_near_float64),
// and f64 adds cost little where the bytes bound the kernel (PERF.md).
//
// Bound on the card: bytes. Each element of x (and of y when it is not x)
// is read once; the outputs are 8 bytes per row. The fnet's 15 norms read
// about 1.0 GB of f32 per 512x1024 forward.
//
// Design: one block per row, 512 threads, 16-byte vector loads (4 f32 or
// 8 bf16 per load) in a block-stride loop with f64 accumulators, then a
// warp-shuffle and shared memory tree in f64. When y is x the second
// stream is not loaded at all. The fixed reduction order makes the sums
// deterministic. The TPU kernel's lane
// tiling (_slot_view) only fills 128-lane vregs and has no counterpart
// here. Rows are not split across blocks (256 to 512 rows at the fnet
// shapes); the short rows of the smallest shape are the first thing a
// speed pass would split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one 16-byte vector of x (and y) as 4 f32 or 8 bf16 values, upcast
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kElems = 4;
  float v[kElems];
  __device__ __forceinline__ void load(const float* p, long long i) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
};

template <> struct Vec<uint16_t> {
  static constexpr int kElems = 8;
  float v[kElems];
  __device__ __forceinline__ void load(const uint16_t* p, long long i) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const unsigned int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: high half word
      v[2 * j] = __uint_as_float(ws[j] << 16);
      v[2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float load_one(const float* p, long long i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_one(const uint16_t* p, long long i) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return __uint_as_float(static_cast<unsigned int>(b) << 16);
}

template <typename T, bool kSame>
__global__ void __launch_bounds__(kThreads)
    row_sums_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    float* __restrict__ s1, float* __restrict__ s2,
                    long long n, int vectorised) {
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  const T* yr = y + row * n;
  double a1 = 0.0;
  double a2 = 0.0;
  if (vectorised) {
    const long long nv = n / Vec<T>::kElems;
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      Vec<T> xv, yv;
      xv.load(xr, i);
      if (!kSame) yv.load(yr, i);
#pragma unroll
      for (int e = 0; e < Vec<T>::kElems; ++e) {
        const double xx = xv.v[e];
        const double yy = kSame ? xx : static_cast<double>(yv.v[e]);
        a1 += yy;
        a2 += xx * yy;
      }
    }
  } else {
    for (long long i = threadIdx.x; i < n; i += kThreads) {
      const double xx = load_one(xr, i);
      const double yy = kSame ? xx : static_cast<double>(load_one(yr, i));
      a1 += yy;
      a2 += xx * yy;
    }
  }

  __shared__ double sh1[kThreads / 32];
  __shared__ double sh2[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  if (lane == 0) {
    sh1[warp] = a1;
    sh2[warp] = a2;
  }
  __syncthreads();
  if (warp == 0) {
    a1 = lane < kThreads / 32 ? sh1[lane] : 0.0;
    a2 = lane < kThreads / 32 ? sh2[lane] : 0.0;
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      s1[row] = static_cast<float>(a1);
      s2[row] = static_cast<float>(a2);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* s1, void* s2, int rows,
           long long n, cudaStream_t s) {
  const int vectorised = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                         (n % Vec<T>::kElems == 0);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  if (x == y) {
    row_sums_kernel<T, true><<<rows, kThreads, 0, s>>>(xp, yp, o1, o2, n,
                                                       vectorised);
  } else {
    row_sums_kernel<T, false><<<rows, kThreads, 0, s>>>(xp, yp, o1, o2, n,
                                                        vectorised);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the row sums on `stream`; returns cudaGetLastError() as an int.
// is_bf16 != 0 selects bf16 inputs (raw 16-bit words), else f32.
extern "C" int instance_norm_sums(const void* x, const void* y, int is_bf16,
                                  void* s1, void* s2, int rows, long long n,
                                  void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<uint16_t>(x, y, s1, s2, rows, n, s)
                 : launch<float>(x, y, s1, s2, rows, n, s);
}
