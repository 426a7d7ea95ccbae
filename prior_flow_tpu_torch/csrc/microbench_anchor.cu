// Primitive-rate anchors of the card: chained selects, in-row gathers and
// FMAs, the fixed cost of one tile-sized block, and an empty launch.
//
// anchor_chain replaces tools/microbench_vpu_anchor.py::_kernel (launched by
// _build), with gather_plan building the gather's read schedule: for every
// element of an (R, 128) f32 tile x with int32 idx, ILP independent chains y_j = x * (0.5 + 0.1 j) each take K/ILP dependent steps
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
// shared-memory word 32 (128 bytes per clock per SM; the gather's bound
// counts its loads alone, 4 wavefronts per row-step, against the plan's 8).
//
// Design: one warp per 128-wide row, the chains fully unrolled in
// registers. Select and fma: 4 consecutive elements per lane. A select step
// is an opaque PTX setp + selp: LLVM folds select(c1, x, select(c2, x, y))
// into select(c1 | c2, x, y), which would collapse the 256-deep chain into a
// few ORs (ptxas still folds each chain's first select into the chain's
// start, x * c, as a predicated multiply: K - 1 selects per chain remain).
// The fma step calls __fmaf_rn (the library is built with --fmad=false).
//
// Gather: each step stores the row to shared memory and loads it back at
// the gathered addresses; a warp-wide 4-byte access costs one wavefront
// (128 bytes, one per clock per SM) per distinct word in its busiest bank.
// Stored as float4 (4 wavefronts) and read at idx & 127 by 4 consecutive
// elements per lane, a random permutation meets ~3-way conflicts per load:
// ~15.8 wavefronts per row-step. The read schedule (the plan) removes them
// while keeping every step's 128 dependent reads: element c lives in lane
// c % 32, register color(c), where color is a proper 4-edge-coloring of the
// bipartite multigraph joining each element's lane to the lane of its
// source idx[c] (4-regular for a permutation, so König's theorem gives one;
// two Euler splits build it). Register r of lane l is stored at word
// 32 r + l: one wavefront per register. Load r of lane l reads the source
// of its element at word 32 color(idx[c]) + idx[c] % 32, in the source's
// lane's bank; within one color the source lanes are distinct, so every
// load is one wavefront: 8 per row-step. The plan (gather_plan_kernel, one
// thread per row, once per index tensor, the row's state one word per edge
// in shared memory, 32 KB a block of 64 rows) holds each (lane,
// register)'s element and source word, 256 bytes a row. A row that is not a
// permutation is colored as the permutation that keeps each value's first
// occurrence and gives the duplicates the missing values in order: the
// lane bijection holds, loads may conflict, the result is the same. The
// chain double-buffers the row so that one __syncwarp per step orders the
// warp's stores before its loads. Rejected: the row held in registers and
// gathered by __shfl_sync, 4 shuffles and a select per element, 16 warp
// shuffles per step at 32 lanes per clock per SM, twice the plan's 8
// wavefronts. tools/microbench_vpu_anchor.py timed the tool's 65536 rows
// on an H100 80GB HBM3 at 700 W: 0.5257 ms per gather chain (ilp 1), the
// 8 wavefronts' 0.5136 ms and the last blocks' tail; 1.034 ms before the
// plan; the plan 0.2422 ms (0.7633 with the row's state in per-thread
// local arrays, whose divergent indices cost up to 32 L1 wavefronts a warp
// access). The TPU kernel's (512, 128) VMEM tiles and its fori_loop do not
// carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kChainK = 256;
constexpr int kTileFloat4 = 8 * kLanes / 4;  // one (8, 128) f32 tile
constexpr int kRegs = kLanes / 32;           // elements per lane
constexpr int kPlanThreads = 64;             // rows per plan block

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

// The chains of one row, select or fma: lane l holds elements 4l .. 4l+3.
template <int KIND, int ILP>
__device__ __forceinline__ void alu_chains(const float4* __restrict__ x,
                                           const int4* __restrict__ idx,
                                           float4* __restrict__ out,
                                           int row, int lane) {
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
#pragma unroll
  for (int k = 0; k < kChainK / ILP; ++k) {
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
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[e] = y[0][e];
#pragma unroll
    for (int j = 1; j < ILP; ++j) o[e] = o[e] + y[j][e];
  }
  out[at] = make_float4(o[0], o[1], o[2], o[3]);
}

// The gather chains of one row on its plan: lane l, register r holds the
// element plan[row][l][r][0] and reads its source at shared word
// plan[row][l][r][1]; wbuf is the warp's 2 x ILP x 128 floats.
template <int ILP>
__device__ __forceinline__ void gather_chains(const float* __restrict__ x,
                                              const uint2* __restrict__ plan,
                                              float* __restrict__ out,
                                              float* wbuf, int row, int lane) {
  const uint2 p = __ldg(plan + static_cast<size_t>(row) * 32 + lane);
  const unsigned words[2] = {p.x, p.y};
  int elem[kRegs], src[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const unsigned w = words[r / 2] >> (16 * (r % 2));
    elem[r] = static_cast<int>(w & 0xffu);
    src[r] = static_cast<int>((w >> 8) & 0xffu);
  }
  const float* xr = x + static_cast<size_t>(row) * kLanes;
  float y[ILP][kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const float xs = __ldg(xr + elem[r]);
#pragma unroll
    for (int j = 0; j < ILP; ++j) y[j][r] = xs * static_cast<float>(0.5 + 0.1 * j);
  }
#pragma unroll
  for (int k = 0; k < kChainK / ILP; ++k) {
    float* b = wbuf + (k & 1) * ILP * kLanes;
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
#pragma unroll
      for (int r = 0; r < kRegs; ++r) b[j * kLanes + 32 * r + lane] = y[j][r];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
#pragma unroll
      for (int r = 0; r < kRegs; ++r) y[j][r] = b[j * kLanes + src[r]];
    }
  }
  float* orow = out + static_cast<size_t>(row) * kLanes;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    float o = y[0][r];
#pragma unroll
    for (int j = 1; j < ILP; ++j) o = o + y[j][r];
    orow[elem[r]] = o;
  }
}

// aux: idx (R, 128) int32 for select and fma, the plan (R, 32, 4, 2) uint8
// for gather.
template <int KIND, int ILP>
__global__ void __launch_bounds__(kThreads)
    anchor_chain_kernel(const float* __restrict__ x,
                        const void* __restrict__ aux, float* __restrict__ out,
                        int rows) {
  constexpr int kBuf = KIND == kGather ? kRowsPerBlock * 2 * ILP * kLanes : 1;
  __shared__ __align__(16) float buf[kBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together
  if constexpr (KIND == kGather) {
    gather_chains<ILP>(x, static_cast<const uint2*>(aux), out,
                       buf + warp * (2 * ILP * kLanes), row, lane);
  } else {
    alu_chains<KIND, ILP>(reinterpret_cast<const float4*>(x),
                          static_cast<const int4*>(aux),
                          reinterpret_cast<float4*>(out), row, lane);
  }
}

// The plan kernel keeps one 32-bit word per edge c of its row in shared
// memory, entry c of thread t at word c * kPlanThreads + t, so that a
// warp's 32 rows touch 32 banks whatever their indices:
constexpr int kV = 0;                 // bits 0-7: v[c] = idx[c] & 127
constexpr int kPi = 8;                // bits 8-15: pi[c], then a slot's edge
constexpr int kRl = 16;               // bits 16-23: the source lanes' edges
constexpr unsigned kUsed = 1u << 24;  // walked in the current split
constexpr unsigned kHalf1 = 1u << 25; // the first split's half
constexpr unsigned kHalf2 = 1u << 26; // the second split's half
constexpr unsigned kTaken = 1u << 27; // the value c occurs in pi
constexpr int kCnt = 28;              // bits 28-30 (c < 32): lane c's edges listed
constexpr unsigned kNone = 0xffu;

struct PlanRow {
  unsigned* base;  // this thread's entry 0
  __device__ __forceinline__ unsigned& operator[](int c) const {
    return base[c * kPlanThreads];
  }
};

__device__ __forceinline__ int field(unsigned w, int at) {
  return static_cast<int>((w >> at) & 0xffu);
}

__device__ __forceinline__ int color_of(unsigned w) {
  return (w & kHalf1 ? 2 : 0) + (w & kHalf2 ? 1 : 0);
}

// One Euler split of a row's 128 edges (edge c joins lane c % 32 to lane
// pi[c] % 32): closed trails, each started at the lowest unused edge and
// continued at each vertex by its lowest unused edge (a lane's edges are
// c, c + 32, c + 64, c + 96; the rl fields of entries 4 s .. 4 s + 3 list
// source lane s's edges in increasing order), end when they come back to
// their first lane. Every edge walked from a source lane back to a lane
// gets `half`. With `within`, a trail keeps to the edges of its first
// edge's first half. Each vertex gives as many edges to each half as it
// keeps.
__device__ __forceinline__ void euler_split(const PlanRow& e, unsigned half,
                                            bool within) {
  int next = 0, cur = 0, v0 = 0;
  bool open = false, at_lane = true;
  unsigned group = 0;
  for (int t = 0; t < kLanes; ++t) {
    int pick = 0;
    if (!open) {
      while (e[next] & kUsed) ++next;
      pick = next;
      v0 = pick & 31;
      group = e[pick] & kHalf1;
    } else {
#pragma unroll
      for (int m = kRegs - 1; m >= 0; --m) {   // the lowest candidate wins
        const int c = at_lane ? cur + 32 * m : field(e[4 * cur + m], kRl);
        const unsigned w = e[c];
        if (!(w & kUsed) && (!within || (w & kHalf1) == group)) pick = c;
      }
    }
    const bool back = open && !at_lane;
    e[pick] |= back ? (kUsed | half) : kUsed;
    if (back) {
      cur = pick & 31;
      at_lane = true;
      open = cur != v0;
    } else {
      cur = field(e[pick], kPi) & 31;
      at_lane = false;
      open = true;
    }
  }
  for (int c = 0; c < kLanes; ++c) e[c] &= ~kUsed;
}

// The gather's read schedule of one row per thread: plan[row][l][r] =
// (element, source word) of lane l's register r, color the edge coloring
// of the two splits.
__global__ void __launch_bounds__(kPlanThreads)
    gather_plan_kernel(const int4* __restrict__ idx, uint4* __restrict__ plan,
                       int rows) {
  __shared__ unsigned entries[kLanes * kPlanThreads];
  const int row = blockIdx.x * kPlanThreads + threadIdx.x;
  if (row >= rows) return;  // no barrier follows
  const PlanRow e{entries + threadIdx.x};
  const int4* ir = idx + static_cast<size_t>(row) * (kLanes / 4);
  for (int q = 0; q < kLanes / 4; ++q) {
    const int4 a = __ldg(ir + q);
    e[4 * q] = static_cast<unsigned>(a.x) & (kLanes - 1);
    e[4 * q + 1] = static_cast<unsigned>(a.y) & (kLanes - 1);
    e[4 * q + 2] = static_cast<unsigned>(a.z) & (kLanes - 1);
    e[4 * q + 3] = static_cast<unsigned>(a.w) & (kLanes - 1);
  }
  // pi: v where a value occurs first; the duplicates, in order, take the
  // values v misses, in order
  for (int c = 0; c < kLanes; ++c) {
    const int u = field(e[c], kV);
    const unsigned taken = e[u] & kTaken;
    e[u] |= kTaken;
    e[c] |= (taken ? kNone : static_cast<unsigned>(u)) << kPi;
  }
  for (int c = 0, f = 0; c < kLanes; ++c) {
    if (field(e[c], kPi) != static_cast<int>(kNone)) continue;
    while (e[f] & kTaken) ++f;
    e[f] |= kTaken;
    e[c] = (e[c] & ~(kNone << kPi)) | (static_cast<unsigned>(f) << kPi);
  }
  // rl: each source lane's 4 edges in increasing order
  for (int c = 0; c < kLanes; ++c) {
    const int s = field(e[c], kPi) & 31;
    const int n = static_cast<int>((e[s] >> kCnt) & 7u);
    e[4 * s + n] |= static_cast<unsigned>(c) << kRl;
    e[s] += 1u << kCnt;
  }
  euler_split(e, kHalf1, false);
  euler_split(e, kHalf2, true);
  // the pi fields: the edge of slot (l, r) = 4 l + r
  for (int c = 0; c < kLanes; ++c) e[c] &= ~(kNone << kPi);
  for (int c = 0; c < kLanes; ++c) {
    e[4 * (c & 31) + color_of(e[c])] |= static_cast<unsigned>(c) << kPi;
  }
  uint4* dst = plan + static_cast<size_t>(row) * (2 * kLanes / 16);
  for (int q = 0; q < 2 * kLanes / 16; ++q) {
    unsigned w[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      unsigned word = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = field(e[8 * q + 2 * h + k], kPi);
        const int u = field(e[c], kV);
        const unsigned src = 32u * color_of(e[u]) + (u & 31);
        word |= (static_cast<unsigned>(c) | (src << 8)) << (16 * k);
      }
      w[h] = word;
    }
    dst[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(kTileFloat4)
    step_cost_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o) {
  const size_t at = static_cast<size_t>(blockIdx.x) * kTileFloat4 + threadIdx.x;
  const float4 v = __ldg(x + at);
  o[at] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
}

__global__ void empty_kernel() {}

template <int KIND>
void launch_chain(int ilp, const float* x, const void* aux, float* out,
                  int rows, cudaStream_t s) {
  const unsigned int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (ilp == 1) {
    anchor_chain_kernel<KIND, 1><<<blocks, kThreads, 0, s>>>(x, aux, out, rows);
  } else {
    anchor_chain_kernel<KIND, 4><<<blocks, kThreads, 0, s>>>(x, aux, out, rows);
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int.

// x, out: (rows, 128) f32; aux: idx (rows, 128) int32 for kind 0 select and
// 2 fma, the plan (rows, 32, 4, 2) uint8 of gather_plan for kind 1 gather;
// ilp 1 or 4; K is fixed at 256.
extern "C" int anchor_chain(const void* x, const void* aux, void* out,
                            int rows, int kind, int ilp, void* stream) {
  if (kind < kSelect || kind > kFma || (ilp != 1 && ilp != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xv = static_cast<const float*>(x);
  float* ov = static_cast<float*>(out);
  if (kind == kSelect) {
    launch_chain<kSelect>(ilp, xv, aux, ov, rows, s);
  } else if (kind == kGather) {
    launch_chain<kGather>(ilp, xv, aux, ov, rows, s);
  } else {
    launch_chain<kFma>(ilp, xv, aux, ov, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// idx: (rows, 128) int32; plan: (rows, 32, 4, 2) uint8, written.
extern "C" int gather_plan(const void* idx, void* plan, int rows,
                           void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks = (rows + kPlanThreads - 1) / kPlanThreads;
  gather_plan_kernel<<<blocks, kPlanThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(idx), static_cast<uint4*>(plan), rows);
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
