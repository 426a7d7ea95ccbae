// Primitive-rate anchors of the card: chained selects, in-row gathers and
// FMAs, the fixed cost of one tile-sized block, and an empty launch.
//
// anchor_chain replaces tools/microbench_vpu_anchor.py::_kernel (launched by
// _build): for every element of an (R, 128) f32 tile x with int32 idx, ILP
// independent chains y_j = x * (0.5 + 0.1 j) each take K/ILP dependent steps
// at step k:
//   select: y_j = ((idx & (1 + (k + j) % 7)) != 0) ? x : y_j
//   gather: y_j = y_j[row, idx & 127]          (take_along_axis in the row)
//   fma:    y_j = fma(y_j, x, x)               (one rounding, as XLA fuses it)
// and the output is ((y_0 + y_1) + y_2) + y_3. K = 256; ILP is 1 or 4.
//
// step_cost_copy replaces _copy_kernel (launched by _build_step_cost): o = 2x,
// one (8, 128) f32 tile per block. Timed at 512 and 4096 blocks, the slope is
// the fixed cost of one more block; empty_kernel is the cost of one launch.
//
// Bound on the card: operations. One launch at the tool's size (65536 rows)
// moves 96 MB (0.03 ms at 3.35 TB/s) and does 2.15e9 chain steps: FFMA issues
// 128 results per clock per SM on sm_90, a select 64 (the ALU pipe of the
// compare row of the CUDA C++ Programming Guide's throughput table), a
// shared-memory word 32 (128 bytes per clock per SM).
//
// Design: one warp per 128-wide row, 4 consecutive elements per lane, the
// chains fully unrolled in registers. A select step is an opaque PTX
// setp + selp: LLVM folds select(c1, x, select(c2, x, y)) into
// select(c1 | c2, x, y), which would collapse the 256-deep chain into a few
// ORs (ptxas still folds each chain's first select into the chain's start,
// x * c, as a predicated multiply: K - 1 selects per chain remain). The
// gather keeps each chain's row in shared memory, double-buffered so
// that one __syncwarp per step orders the warp's store before its 4 loads;
// the 128 x 4-byte row spans the 32 banks four times, so the random in-row
// reads meet bank conflicts, as the TPU's lane gathers do not. The fma step
// calls __fmaf_rn (the library is built with --fmad=false). The TPU kernel's
// (512, 128) VMEM tiles and its fori_loop do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kChainK = 256;
constexpr int kTileFloat4 = 8 * kLanes / 4;  // one (8, 128) f32 tile

enum Kind : int { kSelect = 0, kGather = 1, kFma = 2 };

__device__ __forceinline__ float select_step(unsigned bits, float x, float y) {
  float out;
  asm("{\n\t"
      ".reg .pred p;\n\t"
      "setp.ne.u32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t"
      "}"
      : "=f"(out)
      : "f"(x), "f"(y), "r"(bits));
  return out;
}

template <int KIND, int ILP>
__global__ void __launch_bounds__(kThreads)
    anchor_chain_kernel(const float4* __restrict__ x,
                        const int4* __restrict__ idx, float4* __restrict__ out,
                        int rows) {
  constexpr int kBuf = KIND == kGather ? kRowsPerBlock * 2 * ILP * kLanes : 1;
  __shared__ __align__(16) float buf[kBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t at = static_cast<size_t>(row) * (kLanes / 4) + lane;
  const float4 xv = __ldg(x + at);
  const int4 iv = __ldg(idx + at);
  const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const int is[4] = {iv.x, iv.y, iv.z, iv.w};

  float y[ILP][4];
#pragma unroll
  for (int j = 0; j < ILP; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = xs[e] * static_cast<float>(0.5 + 0.1 * j);
  }

  float* wbuf = buf + warp * (2 * ILP * kLanes);
#pragma unroll
  for (int k = 0; k < kChainK / ILP; ++k) {
    if (KIND == kGather) {
      float* b = wbuf + (k & 1) * ILP * kLanes;
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        reinterpret_cast<float4*>(b + j * kLanes)[lane] =
            make_float4(y[j][0], y[j][1], y[j][2], y[j][3]);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) y[j][e] = b[j * kLanes + (is[e] & (kLanes - 1))];
      }
    } else {
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const unsigned m = 1u + static_cast<unsigned>((k + j) % 7);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[j][e] = KIND == kSelect
                        ? select_step(static_cast<unsigned>(is[e]) & m, xs[e], y[j][e])
                        : __fmaf_rn(y[j][e], xs[e], xs[e]);
        }
      }
    }
  }

  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[e] = y[0][e];
#pragma unroll
    for (int j = 1; j < ILP; ++j) o[e] = o[e] + y[j][e];
  }
  out[at] = make_float4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kTileFloat4)
    step_cost_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o) {
  const size_t at = static_cast<size_t>(blockIdx.x) * kTileFloat4 + threadIdx.x;
  const float4 v = __ldg(x + at);
  o[at] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
}

__global__ void empty_kernel() {}

template <int KIND>
void launch_chain(int ilp, const float4* x, const int4* idx, float4* out,
                  int rows, cudaStream_t s) {
  const unsigned int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (ilp == 1) {
    anchor_chain_kernel<KIND, 1><<<blocks, kThreads, 0, s>>>(x, idx, out, rows);
  } else {
    anchor_chain_kernel<KIND, 4><<<blocks, kThreads, 0, s>>>(x, idx, out, rows);
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int.

// x, out: (rows, 128) f32; idx: (rows, 128) int32; kind 0 select, 1 gather,
// 2 fma; ilp 1 or 4; K is fixed at 256.
extern "C" int anchor_chain(const void* x, const void* idx, void* out, int rows,
                            int kind, int ilp, void* stream) {
  if (kind < kSelect || kind > kFma || (ilp != 1 && ilp != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* xv = static_cast<const float4*>(x);
  const int4* iv = static_cast<const int4*>(idx);
  float4* ov = static_cast<float4*>(out);
  if (kind == kSelect) {
    launch_chain<kSelect>(ilp, xv, iv, ov, rows, s);
  } else if (kind == kGather) {
    launch_chain<kGather>(ilp, xv, iv, ov, rows, s);
  } else {
    launch_chain<kFma>(ilp, xv, iv, ov, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, o: (tiles * 8, 128) f32, one block per tile.
extern "C" int step_cost_copy(const void* x, void* o, int tiles, void* stream) {
  if (tiles <= 0) return static_cast<int>(cudaGetLastError());
  step_cost_copy_kernel<<<tiles, kTileFloat4, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
