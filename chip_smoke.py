#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (non-zero exit, no result line):
1. build the CUDA kernels from ``prior_flow_tpu_torch/csrc``;
2. the DCCL level-lookup kernel against its plain version at the four
   pyramid-level shapes of a 512x1024 forward (batch 1) and of the batch-4
   training step (B x Q = 32768 queries), f32 and bf16 volumes;
3. the instance-norm sums kernel against its plain version at the three
   fnet shapes, f32 and bf16;
4. the test-mode forward at 512x1024, batch 1, 12 iterations, seeded
   random weights, fp32 then mixed precision: output shape, finiteness,
   launch counts per forward (48 lookups, 15 norms), median ms/pair;
5. the same weights on the card and on the CPU at 128x256, 4 iterations;
6. the cross-tap-coords kernel against its plain version at the training
   size (N = 12 x 4 x 8192 centres, four level scales, both grids):
   bitwise; and the lookup kernel's cross taps, at batch 4, bitwise equal
   to the plain sampler of the other volume at the coords kernel's coords;
7. the volume-scatter kernel against its plain version at the training
   level shapes (B = 4), S = 1 and 12, f32 and bf16 output;
8. the instance-norm sums of a batch-4 step, forward (x, x) in bf16 and
   backward (xhat, dy) in f32 with a zero-mean dy, at the three fnet shapes
   (B = 16), within the rounding of an f64-accumulated sum;
9. the training step at the EFT recipe: 512x1024, batch 4, 12 iterations,
   bf16 autocast, AdamW + OneCycle + clip 1.0, seeded weights and batches,
   both grad modes: launch counts per step, loss and grad norm of each
   step, median ms/step, peak GB; standard and taped agree on the first
   step's loss and gradients;
10. one step on the card and on the CPU at 128x256, batch 1, 2 iterations,
   f32, both grad modes, same weights;
11. the lookup at given cross coords against its plain version and against
   the grid lookup (kernel 1), bitwise, at the four level shapes of a
   1024x2048 forward (B x Q = 32768), f32 and bf16, with the coords from
   the coords kernel (the planes route); one bf16 level-0 launch at batch
   3 (more than 2^31 volume elements) checked on its first and last batch
   element;
12. the all-levels lookup against four per-level launches, bitwise, at
   512x1024, batch 1 and 4, f32 and bf16;
13. the chunked pyramid build against the dense one at 512x1024 and
   1024x2048, f32 and bf16 (bitwise expected; else gated at 2^-20 of
   max|level| in f32 and one bf16 step), ms and peak GB of each;
14. the 1024x2048 test-mode forward, batch 1, 12 iterations, fp32 then bf16
   (48 lookups at given coords, 24 coords launches, no kernel 1, 15 norms
   per forward; median ms/pair over 5 runs; peak GB); the 128x256 forward
   with the chunked build and the planes route forced on the card against
   the CPU's default routes; the 512x1024 fp32 forward with
   PRIORFLOW_DCCL_FUSE_LEVELS=1 (12 all-levels launches, no kernel 1) within
   1e-5 x flow scale of phase 4's flow.
Then the card's name and power limit, a ``kernels`` JSON line with each
kernel's launches per path, error, times and bound, and the result line.

TF32 is off for matmuls and cuDNN convolutions in every phase, so "fp32"
is full f32 and the card-vs-CPU comparisons are like for like.
``--profile`` adds a torch.profiler kernel breakdown of one forward per
precision (512x1024 and 1024x2048) and of one training step per grad
mode. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

H, W, ITERS = 512, 1024, 12
FNET_SHAPES = [(4, 64, 256, 512), (4, 96, 128, 256), (4, 128, 64, 128)]
# the high-resolution path: a 1024x2048 pair, batch 1 (ROADMAP Queue 2
# items 4 and 5), and its fnet norm shapes
H2, W2 = 1024, 2048
FNET_SHAPES_HR = [(4, 64, 512, 1024), (4, 96, 256, 512), (4, 128, 128, 256)]
NORMS_PER_SHAPE = 5
LOOKUP_ATOL = 2e-5        # unit-scale volumes; kernel and plain round alike
SUMS_RTOL = SUMS_ATOL = 1e-5
# sums of a train step: both sides accumulate in f64 and round to f32, so
# they may differ by one f32 rounding plus the f64 sums' own error bound
SUMS_F32_ROUND = 2.0 ** -23
SUMS_F64_EPS = 2.0 ** -53
# f64 multiply and two adds per element, each counted as two f32
# operations: an H100's f64 rate outside the tensor cores (34 TFLOP/s on
# the SXM data sheet) is half its f32 rate
SUMS_OPS_PER_ELEM = 6
CARD_CPU_TOL = 1e-3       # max abs error / flow scale, 128x256, 4 iterations
# f32 operations per (query, tap) of one lookup launch, both branches,
# counted from the kernel's arithmetic (2 x (own 35 + grid 47 + cross 35 + 4))
LOOKUP_OPS_PER_TAP = 242
# the training step: the EFT recipe (scripts/train_EFT.sh) at full ERP size
TRAIN_B, TRAIN_STEPS = 4, 5
TRAIN_LR, TRAIN_NUM_STEPS = 1e-4, 60000
LEVELS = 4
# f32 operations per (centre, tap) of the coords kernel (window 4 + grid
# sample 47) and per (s, query, tap) of the scatter kernel (window 4 + two
# corner sets 2 x 23 + eight weighted atomic adds 16)
COORDS_OPS_PER_TAP = 51
SCATTER_OPS_PER_TAP = 66
SCATTER_RTOL = 1e-5       # of max|plain|; atomics reorder the f32 sums
# f32 operations per (query, tap) of the lookup at given coords, both
# branches (2 x (own 35 + cross 35 + window 4)), and the batch of its
# launch with more than 2^31 volume elements
LOOKUP_COORDS_OPS_PER_TAP = 148
BIG_B = 3
# the fused-levels forward against the per-level one: the same kernel
# arithmetic, so only the convolutions' run-to-run rounding may differ
FUSED_FLOW_TOL = 1e-5
MODE_GRAD_RTOL = 2e-2     # standard vs taped: per-iteration bf16 dV sums
STEP_LOSS_RTOL = 1e-5
CARD_CPU_GRAD_RTOL = 1e-3
# the fnet conv biases in front of an instance norm have a zero gradient in
# exact arithmetic and carry only round-off: their norms are floored at
# this share of the global one (every other norm at 1e-6)
ZERO_GRAD_FLOOR = 1e-2
# the port's CUDA kernels by function name, for the profiles
PORT_KERNELS = ("dccl_level_kernel", "dccl_all_levels_kernel",
                "dccl_coords_lookup_kernel", "dccl_coords_kernel",
                "dccl_scatter_kernel", "row_sums_kernel")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_peaks(name: str):
    """(bytes/s, f32 FLOP/s outside the tensor cores) from the data sheet
    of the card ``name`` names; H100 SXM unless the name says otherwise."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 67e12
    if "PCIE" in n:
        return 2.0e12, 51e12
    if "NVL" in n:
        return 3.9e12, 60e12
    return 3.35e12, 67e12


def cuda_ms(fn, n: int, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound(bytes_moved: float, ops: float, peaks):
    t_bytes = bytes_moved / peaks[0] * 1e3
    t_ops = ops / peaks[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: DCCL level lookup ------------------------------------------------

def lookup_inputs(lvl: int, dtype, dev, grids, b: int = 1, size=None):
    """Random level volumes (b, Q, Hl, Wl) of an (H, W) input (``size``,
    default the 512x1024 main path), centres and the input's grids."""
    import torch
    g = torch.Generator(device=dev).manual_seed(100 + lvl)
    h8, w8 = (size or (H, W))[0] // 8, (size or (H, W))[1] // 8
    Q = h8 * w8
    Hl, Wl = h8 >> lvl, w8 >> lvl
    vA = torch.randn(b, Q, Hl, Wl, generator=g, device=dev).to(dtype)
    vB = torch.randn(b, Q, Hl, Wl, generator=g, device=dev).to(dtype)
    # centres over the whole 1/8 image and a margin beyond it, with seam
    # columns, a hair below 0 and the pole rows pinned
    u = torch.rand(2, b, Q, generator=g, device=dev)
    cA = torch.stack([u[0] * (w8 + 4) - 2, u[1] * (h8 + 4) - 2], dim=-1)
    edge = torch.tensor([[w8 - 1, 0.0], [w8 - 0.5, h8 - 1], [-1e-8, 5.0],
                         [-0.5, -0.5], [w8 - 1e-3, h8 - 0.5], [0.0, h8 - 1.0]],
                        device=dev)
    cA[0, :edge.shape[0]] = edge
    cB = torch.roll(cA, 7, dims=1) + 0.31
    return vA, vB, cA.contiguous(), cB.contiguous(), grids.a2b_w2c_8, grids.b2a_w2c_8


def lookup_sample_coords(cA, cB, gA, gB, scale):
    """Own and cross tap coords (1, Q, 81, 2) per branch, as the kernel
    computes them."""
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import window_delta
    from prior_flow_tpu_torch.ops.samplers import cycle_bilinear_sample
    delta = window_delta(4, cA.device)
    out = []
    for cen, grid in ((cA, gA), (cB, gB)):
        own = (cen * scale).unsqueeze(2) + delta
        cross = cycle_bilinear_sample(grid.unsqueeze(0), own.reshape(1, -1, 2))
        out += [own, cross.reshape(own.shape)]
    return out  # own_A, cross_A, own_B, cross_B


def touched_sectors(vol, coord_sets) -> int:
    """32-byte sectors of ``vol`` (1, Q, Hl, Wl) that the valid bilinear
    corners at ``coord_sets`` (each (1, Q, K, 2)) read, counted once."""
    import torch
    _, Q, Hl, Wl = vol.shape
    es = vol.element_size()
    secs = []
    for c in coord_sets:
        x = torch.remainder(c[..., 0], Wl)
        x0, y0 = torch.floor(x), torch.floor(c[..., 1])
        q = torch.arange(Q, device=vol.device).view(1, Q, 1)
        for dy in (0, 1):
            for dx in (0, 1):
                cx, cy = x0 + dx, y0 + dy
                ok = (cx >= 0) & (cx <= Wl - 1) & (cy >= 0) & (cy <= Hl - 1)
                lin = q * (Hl * Wl) + cy.long() * Wl + cx.long()
                secs.append((lin[ok] * es) // 32)
    return int(torch.unique(torch.cat(secs)).numel())


def lookup_bytes(vA, vB, coords, extra: int) -> tuple:
    """Bytes a batch-1 lookup launch must move: the touched sectors of both
    volumes at ``coords`` (own_A, cross_A, own_B, cross_B, as from
    ``lookup_sample_coords``), the 4 output rows and the centres, plus
    ``extra`` bytes (the grids, or the given coords). Returns (bytes,
    sectors)."""
    BQ = vA.shape[1]
    sectors = (touched_sectors(vA, [coords[0], coords[3]])
               + touched_sectors(vB, [coords[2], coords[1]]))
    return sectors * 32 + 4 * BQ * 81 * 4 + 2 * BQ * 2 * 4 + extra, sectors


def grid_sample_library(vA, vB, coords):
    """One level's library yardstick: 4 ``F.grid_sample`` calls at the
    precomputed tap coords (own_A in A, cross_A in B, own_B in B, cross_B
    in A), wrapped and normalised beforehand; None for a 1-pixel extent."""
    import torch
    import torch.nn.functional as F
    _, BQ, Hl, Wl = vA.shape
    if Hl < 2 or Wl < 2:
        return None

    def norm(c):
        xn = torch.remainder(c[..., 0], Wl) * (2.0 / (Wl - 1)) - 1
        yn = c[..., 1] * (2.0 / (Hl - 1)) - 1
        return torch.stack([xn, yn], -1).reshape(BQ, 1, 81, 2)
    gs = [norm(c) for c in coords]
    iA = vA.reshape(BQ, 1, Hl, Wl)
    iB = vB.reshape(BQ, 1, Hl, Wl)

    def library():
        for img, grid in ((iA, gs[0]), (iB, gs[1]), (iB, gs[2]), (iA, gs[3])):
            F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)
    return library


def phase_lookup(dev, grids, peaks):
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        NTAP, dccl_level_lookup, dccl_level_lookup_plain)

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                   err=0.0)
        for lvl in range(4):
            vA, vB, cA, cB, gA, gB = lookup_inputs(lvl, dtype, dev, grids)
            s = 1.0 / 2 ** lvl
            args = (vA, vB, cA, cB, gA, gB, s)
            with torch.no_grad():
                got = dccl_level_lookup(*args)
                ref = dccl_level_lookup_plain(*args)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(got, ref))
                if not err <= LOOKUP_ATOL:
                    fail(f"dccl lookup {tag} level {lvl}: max abs err {err} "
                         f"> {LOOKUP_ATOL}")
                ms = cuda_ms(lambda: dccl_level_lookup(*args), 50)
                plain_ms = cuda_ms(lambda: dccl_level_lookup_plain(*args), 5,
                                   warmup=2)
                coords = lookup_sample_coords(cA, cB, gA, gB, s)
                BQ, Hl, Wl = vA.shape[1], vA.shape[2], vA.shape[3]
                nbytes, sectors = lookup_bytes(vA, vB, coords,
                                               2 * gA.numel() * 4)
                ops = BQ * NTAP * LOOKUP_OPS_PER_TAP
                b_ms, _ = bound(nbytes, ops, peaks)
                library = grid_sample_library(vA, vB, coords)
                lib_ms = None
                if dtype == torch.float32 and library is not None:
                    lib_ms = cuda_ms(library, 50)
            print(f"  dccl {tag} level {lvl} ({BQ}x{Hl}x{Wl}): err {err:.3e} "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
                  f"bound {b_ms:.4f} ms ({sectors} sectors, {nbytes / 1e6:.2f} MB)",
                  flush=True)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes"] += nbytes
            tot["ops"] += ops
            tot["library_ms"] += lib_ms or 0.0
            tot["err"] = max(tot["err"], err)
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"], peaks)
        rows[tag] = tot
        print(f"  dccl {tag} one iteration (4 levels): kernel {tot['ms']:.4f} ms "
              f"plain {tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms",
              flush=True)

    # the shapes of the training step: batch 4, bf16 volumes on its path
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for lvl in range(4):
            args = (*lookup_inputs(lvl, dtype, dev, grids, TRAIN_B),
                    1.0 / 2 ** lvl)
            with torch.no_grad():
                got = dccl_level_lookup(*args)
                ref = dccl_level_lookup_plain(*args)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(got, ref))
                if not err <= LOOKUP_ATOL:
                    fail(f"dccl lookup {tag} level {lvl} batch {TRAIN_B}: max "
                         f"abs err {err} > {LOOKUP_ATOL}")
                ms = cuda_ms(lambda: dccl_level_lookup(*args), 20)
            _, BQ, Hl, Wl = args[0].shape
            print(f"  dccl {tag} level {lvl} batch {TRAIN_B} "
                  f"({TRAIN_B * BQ}x{Hl}x{Wl}): err {err:.3e} kernel "
                  f"{ms:.4f} ms", flush=True)
            rows[tag]["err"] = max(rows[tag]["err"], err)
            del args, got, ref
    return rows


# -- phase 3: instance-norm sums -----------------------------------------------

def phase_sums(dev, peaks):
    import torch
    from prior_flow_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_sums, instance_norm_sums_plain)

    rows = {}
    for dtype, shapes, size in ((torch.float32, FNET_SHAPES, ""),
                                (torch.bfloat16, FNET_SHAPES, ""),
                                (torch.float32, FNET_SHAPES_HR, " 1024x2048"),
                                (torch.bfloat16, FNET_SHAPES_HR, " 1024x2048")):
        tag = ("f32" if dtype == torch.float32 else "bf16") + size
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                   err=0.0)
        for shape in shapes:
            g = torch.Generator(device=dev).manual_seed(sum(shape))
            # activation-like data with a non-zero mean, so each sum is far
            # from 0 and the relative tolerance is meaningful
            x = (torch.randn(shape, generator=g, device=dev) * 3 + 1.5).to(dtype)
            with torch.no_grad():
                got = instance_norm_sums(x, x)
                ref = instance_norm_sums_plain(x, x)
                torch.cuda.synchronize()
                err = 0.0
                for a, b in zip(got, ref):
                    over = (a - b).abs() - (SUMS_ATOL + SUMS_RTOL * b.abs())
                    if over.max().item() > 0:
                        fail(f"instance-norm sums {tag} {shape}: beyond "
                             f"rtol/atol {SUMS_RTOL}")
                    err = max(err, (a - b).abs().max().item())
                ms = cuda_ms(lambda: instance_norm_sums(x, x), 50)
                plain_ms = cuda_ms(lambda: instance_norm_sums_plain(x, x), 20)
                lib_ms = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3)), 50)
            nbytes = x.numel() * x.element_size() + shape[0] * shape[1] * 8
            ops = SUMS_OPS_PER_ELEM * x.numel()
            b_ms, _ = bound(nbytes, ops, peaks)
            print(f"  sums {tag} {shape}: max abs err {err:.3e} kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  var_mean "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms", flush=True)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", ops)):
                tot[k] += NORMS_PER_SHAPE * v
            tot["err"] = max(tot["err"], err)
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"], peaks)
        rows[tag] = tot
        print(f"  sums {tag} one forward (15 norms): kernel {tot['ms']:.4f} ms "
              f"plain {tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms",
              flush=True)
    return rows


# -- phase 4: the main path ------------------------------------------------------

def images(seed: int, h: int, w: int):
    import torch
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(1, h, w, 3, generator=g) * 255 for _ in range(2))


def forward_counts(**nonzero) -> dict:
    """The launch counts of one test-mode forward: 15 instance-norm sums,
    the given DCCL launches, every other kernel 0."""
    from prior_flow_tpu_torch.ops.kernels import WRAPPERS
    want = dict.fromkeys(WRAPPERS, 0)
    want["instance_norm_sums"] = 15
    want.update(nonzero)
    return want


def phase_forward(dev, mixed: bool, i1, i2, want=None, runs: int = 7):
    """The test-mode forward through ``build_model`` on the card: one
    warm-up, one counted run (launch counts against ``want``, default the
    512x1024 grid route's: 48 lookups), then ``runs`` timed runs."""
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    tag = "bf16" if mixed else "fp32"
    _, h, w, _ = i1.shape
    model = build_model(seed=0, mixed_precision=mixed)   # default: the card
    model(i1, i2, iters=ITERS)                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    flow = model(i1, i2, iters=ITERS)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(flow.shape) != (1, h, w, 2):
        fail(f"{tag} forward: shape {tuple(flow.shape)}")
    if not bool(torch.isfinite(flow).all()):
        fail(f"{tag} forward: non-finite output")
    want = want or forward_counts(dccl_level_lookup=4 * ITERS)
    if counts != want:
        fail(f"{tag} forward {h}x{w}: launch counts {counts}, expected {want}")
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model(i1, i2, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    print(f"  forward {tag} {h}x{w} iters {ITERS}: launches {counts}; "
          f"median {med:.2f} ms/pair over {len(times)} runs "
          f"(min {min(times):.2f}, max {max(times):.2f}); peak "
          f"{peak_gb:.2f} GB; flow |max| {flow.abs().max().item():.3f}",
          flush=True)
    return model, flow, counts, med, peak_gb


def profile_forward(model, i1, i2, tag: str):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(i1, i2, iters=ITERS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel events only: the aten:: op events carry their kernels' device
    # time a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ours = {k: sum(e.self_device_time_total for e in events if k in e.key)
            / 1e3 for k in PORT_KERNELS}
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"  profile {tag}: wall {wall:.2f} ms (profiled), device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%); port kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v),
          flush=True)
    for e in events[:20]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


# -- phase 6: cross tap coords --------------------------------------------------

def train_centres(dev, N: int, seed: int):
    """N unscaled 1/8 centres over the image and a margin, with the seam,
    a hair below 0 and the pole rows pinned (as in lookup_inputs)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    h8, w8 = H // 8, W // 8
    u = torch.rand(2, N, generator=g, device=dev)
    c = torch.stack([u[0] * (w8 + 4) - 2, u[1] * (h8 + 4) - 2], dim=-1)
    c[:6] = torch.tensor([[w8 - 1, 0.0], [w8 - 0.5, h8 - 1], [-1e-8, 5.0],
                          [-0.5, -0.5], [w8 - 1e-3, h8 - 0.5],
                          [0.0, h8 - 1.0]], device=dev)
    return c.contiguous()


def phase_coords(dev, grids, peaks):
    import torch
    import torch.nn.functional as F
    from prior_flow_tpu_torch.ops.kernels.dccl_coords import (
        dccl_grid_coords, dccl_grid_coords_plain)
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        NTAP, dccl_level_lookup, sample_volume_level, window_delta)

    N = ITERS * TRAIN_B * (H // 8) * (W // 8)
    Hg, Wg = H // 8, W // 8
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
               err=0.0)
    for branch, grid in (("A", grids.a2b_w2c_8), ("B", grids.b2a_w2c_8)):
        cen = train_centres(dev, N, 7 if branch == "A" else 8)
        for lvl in range(LEVELS):
            s = 1.0 / 2 ** lvl
            with torch.no_grad():
                cx, cy = dccl_grid_coords(cen, grid, s)
                rx, ry = dccl_grid_coords_plain(cen, grid, s)
                torch.cuda.synchronize()
                if not (torch.equal(cx, rx) and torch.equal(cy, ry)):
                    err = max((cx - rx).abs().max().item(),
                              (cy - ry).abs().max().item())
                    fail(f"coords {branch} level {lvl}: not bitwise equal to "
                         f"the plain version (max abs err {err})")
                ms = cuda_ms(lambda: dccl_grid_coords(cen, grid, s), 20)
                plain_ms = cuda_ms(
                    lambda: dccl_grid_coords_plain(cen, grid, s), 3, warmup=1)
                # library: F.grid_sample of the grid at the window coords,
                # wrapped and normalised beforehand
                win = (cen * s).unsqueeze(1) + window_delta(4, dev)
                xn = torch.remainder(win[..., 0], Wg) * (2.0 / (Wg - 1)) - 1
                yn = win[..., 1] * (2.0 / (Hg - 1)) - 1
                gn = torch.stack([xn, yn], -1).reshape(1, N, NTAP, 2)
                img = grid.permute(2, 0, 1).unsqueeze(0).contiguous()
                lib_ms = cuda_ms(lambda: F.grid_sample(
                    img, gn, mode="bilinear", padding_mode="zeros",
                    align_corners=True), 20)
                del win, xn, yn, gn
            nbytes = N * 8 + 2 * N * NTAP * 4 + grid.numel() * 4
            ops = N * NTAP * COORDS_OPS_PER_TAP
            b_ms, _ = bound(nbytes, ops, peaks)
            print(f"  coords {branch} level {lvl} (N={N}): bitwise equal; "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  grid_sample "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms", flush=True)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", ops)):
                tot[k] += v
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"], peaks)
    print(f"  coords one taped step (8 launches): kernel {tot['ms']:.4f} ms "
          f"plain {tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms",
          flush=True)

    # the lookup kernel's cross taps are the plain sampler of the other
    # volume at the coords kernel's coords, bit for bit, at the training
    # batch
    for lvl in range(LEVELS):
        vA, vB, cA, cB, gA, gB = lookup_inputs(lvl, torch.float32, dev, grids,
                                               TRAIN_B)
        s = 1.0 / 2 ** lvl
        with torch.no_grad():
            _, cross_A, _, cross_B = dccl_level_lookup(vA, vB, cA, cB, gA, gB,
                                                       s)
            for cross, cen, grid, other in ((cross_A, cA, gA, vB),
                                            (cross_B, cB, gB, vA)):
                cx, cy = dccl_grid_coords(cen.reshape(-1, 2), grid, s)
                at = torch.stack([cx, cy], -1).reshape(*cen.shape[:2], NTAP, 2)
                if not torch.equal(cross, sample_volume_level(other, at)):
                    fail(f"lookup level {lvl}: cross taps differ from the "
                         f"plain sampler at the coords kernel's coords")
        del vA, vB, cross_A, cross_B
    print(f"  lookup cross taps == plain sampler at the coords kernel's "
          f"coords, batch {TRAIN_B}, all levels, both branches: bitwise",
          flush=True)
    return tot


# -- phase 7: volume scatter -----------------------------------------------------

def scatter_inputs(dev, lvl: int, S: int, grids):
    """Tap cotangents, own centres and the other branch's cross coords (from
    the coords kernel) at the training shape of one level."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_coords import dccl_grid_coords
    Q = (H // 8) * (W // 8)
    g = torch.Generator(device=dev).manual_seed(200 + lvl)
    shape = (S, TRAIN_B, Q, 81)
    g_own = torch.randn(shape, generator=g, device=dev)
    g_cross = torch.randn(shape, generator=g, device=dev)
    cen = train_centres(dev, S * TRAIN_B * Q, 300 + lvl)
    other = train_centres(dev, S * TRAIN_B * Q, 400 + lvl)
    with torch.no_grad():
        cx, cy = dccl_grid_coords(other, grids.b2a_w2c_8, 1.0 / 2 ** lvl)
    return (g_own, cen.reshape(S, TRAIN_B, Q, 2), g_cross,
            cx.reshape(shape), cy.reshape(shape))


def scatter_corners(g_own, cen, scale, g_cross, cx, cy, Hl, Wl):
    """Flat indices and values of every weighted corner, the scatter's
    input to ``index_put_``."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import window_delta
    from prior_flow_tpu_torch.ops.kernels.dccl_scatter import _corners
    S, B, Q, _ = g_own.shape
    own = (cen * scale).unsqueeze(-2) + window_delta(4, cen.device)
    base = (torch.arange(B * Q, device=cen.device) * (Hl * Wl)).reshape(
        1, B, Q, 1)
    idx, val = [], []
    for g, x, y in ((g_own, own[..., 0], own[..., 1]), (g_cross, cx, cy)):
        for i, w in _corners(x, y, Hl, Wl):
            idx.append((base + i).reshape(-1))
            val.append((g * w).reshape(-1))
    return torch.cat(idx), torch.cat(val)


def phase_scatter(dev, grids, peaks):
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_scatter import (
        dccl_level_scatter, dccl_level_scatter_plain)

    Q = (H // 8) * (W // 8)
    taped = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                 err=0.0)
    standard_ms = 0.0
    for lvl in range(LEVELS):
        Hl, Wl = (H // 8) >> lvl, (W // 8) >> lvl
        s = 1.0 / 2 ** lvl
        full = scatter_inputs(dev, lvl, ITERS, grids)
        for S in (1, ITERS):
            ins = [t[:S].contiguous() for t in full]
            args = (ins[0], ins[1], s, ins[2], ins[3], ins[4], Hl, Wl)
            for dtype in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    got = dccl_level_scatter(*args, dtype).float()
                    ref = dccl_level_scatter_plain(*args, dtype).float()
                    torch.cuda.synchronize()
                    top = ref.abs().max().item()
                    tol = SCATTER_RTOL * top + 1e-6
                    over = (got - ref).abs() - tol
                    if dtype == torch.bfloat16:   # one bf16 step apart
                        over = over - 2.0 ** -7 * ref.abs()
                    if over.max().item() > 0:
                        fail(f"scatter level {lvl} S={S} {dtype}: beyond "
                             f"tolerance (max abs err "
                             f"{(got - ref).abs().max().item():.3e}, "
                             f"max|plain| {top:.3e})")
                    err = (got - ref).abs().max().item()
                    if dtype == torch.float32:
                        taped["err"] = max(taped["err"], err)
                del got, ref
            with torch.no_grad():
                ms = cuda_ms(lambda: dccl_level_scatter(*args, torch.bfloat16),
                             10, warmup=2)
            if S == 1:
                standard_ms += 2 * ms
                print(f"  scatter level {lvl} ({TRAIN_B}x{Q}x{Hl}x{Wl}) S=1 "
                      f"bf16: kernel {ms:.4f} ms", flush=True)
                continue
            with torch.no_grad():
                plain_ms = cuda_ms(lambda: dccl_level_scatter_plain(
                    *args, torch.bfloat16), 2, warmup=1)
                idx, val = scatter_corners(*args)
                out = torch.zeros(TRAIN_B * Q * Hl * Wl, device=dev)
                lib_ms = cuda_ms(lambda: out.index_put_((idx,), val,
                                                        accumulate=True),
                                 5, warmup=1)
                del idx, val, out
            nbytes = (4 * S * TRAIN_B * Q * 81 * 4 + S * TRAIN_B * Q * 8
                      + TRAIN_B * Q * Hl * Wl * 2)
            ops = S * TRAIN_B * Q * 81 * SCATTER_OPS_PER_TAP
            b_ms, _ = bound(nbytes, ops, peaks)
            print(f"  scatter level {lvl} ({TRAIN_B}x{Q}x{Hl}x{Wl}) S={S} "
                  f"bf16: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"index_put_ {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
                  f"({nbytes / 1e9:.3f} GB)", flush=True)
            # one taped step scatters both volumes of every level once
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", ops)):
                taped[k] += 2 * v
        del full
        torch.cuda.empty_cache()
    taped["bound_ms"], taped["bound_by"] = bound(taped["bytes"], taped["ops"],
                                                 peaks)
    taped["standard_step_ms"] = ITERS * standard_ms
    print(f"  scatter one taped step (8 launches, S={ITERS}): kernel "
          f"{taped['ms']:.4f} ms plain {taped['plain_ms']:.4f} ms bound "
          f"{taped['bound_ms']:.4f} ms; one standard step (96 launches, S=1): "
          f"{taped['standard_step_ms']:.4f} ms", flush=True)
    return taped


# -- phase 8: instance-norm sums of the backward ---------------------------------

def phase_sums_backward(dev, peaks):
    """The sums of a batch-4 step: 15 forward (x, x) in bf16 and 15
    backward (xhat, dy) in f32, at B = 4 x 4 views."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_sums, instance_norm_sums_plain)

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
               err=0.0)
    for shape in [(4 * TRAIN_B,) + s[1:] for s in FNET_SHAPES]:
        g = torch.Generator(device=dev).manual_seed(sum(shape) + 1)
        xf = torch.randn(shape, generator=g, device=dev) * 3 + 1.5
        x = xf.to(torch.bfloat16)
        n = shape[2] * shape[3]
        m = xf.mean(dim=(2, 3), keepdim=True)
        xhat = (xf - m) * torch.rsqrt(xf.var(dim=(2, 3), unbiased=False,
                                             keepdim=True) + 1e-5)
        # an upstream gradient as a backward sees it: zero mean and no share
        # along xhat, so both of its sums lie near 0
        dy = torch.randn(shape, generator=g, device=dev)
        with torch.no_grad():
            for a, b, tag in ((x, x, "forward bf16"), (xhat, dy,
                                                       "backward f32")):
                got = instance_norm_sums(a, b)
                ref = instance_norm_sums_plain(a, b)
                torch.cuda.synchronize()
                ad, bd = a.double(), b.double()
                terms = (bd.abs().sum(dim=(2, 3)),
                         (ad * bd).abs().sum(dim=(2, 3)))
                for u, v, t, what in zip(got, ref, terms, ("y", "x*y")):
                    # one f32 rounding of the result, plus the f64 sums'
                    # error bound on either side (n eps64 sum|terms|)
                    tol = (SUMS_F32_ROUND * v.abs().double()
                           + 2 * n * SUMS_F64_EPS * t)
                    diff = (u - v).abs().double()
                    if (diff > tol).any().item():
                        i = int(torch.argmax(diff - tol))
                        fail(f"instance-norm sums {tag} {shape} sum({what}): "
                             f"{u.flatten()[i].item()} vs plain "
                             f"{v.flatten()[i].item()} (sum|terms| "
                             f"{t.flatten()[i].item():.4e})")
                    tot["err"] = max(tot["err"], diff.max().item())
                del ad, bd, terms
            ms = (cuda_ms(lambda: instance_norm_sums(x, x), 20)
                  + cuda_ms(lambda: instance_norm_sums(xhat, dy), 20))
            plain_ms = (cuda_ms(lambda: instance_norm_sums_plain(x, x), 10)
                        + cuda_ms(lambda: instance_norm_sums_plain(xhat, dy),
                                  10))
            fx, fy = xhat.flatten(2), dy.flatten(2)
            lib_ms = (cuda_ms(lambda: torch.var_mean(x, dim=(2, 3)), 20)
                      + cuda_ms(lambda: torch.linalg.vecdot(fx, fy), 20))
        nbytes = (x.numel() * 2 + 2 * xhat.numel() * 4
                  + 2 * shape[0] * shape[1] * 8)
        ops = SUMS_OPS_PER_ELEM * (x.numel() + xhat.numel())
        b_ms, _ = bound(nbytes, ops, peaks)
        print(f"  sums {shape}: forward + backward kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  var_mean + vecdot {lib_ms:.4f} ms  bound "
              f"{b_ms:.4f} ms", flush=True)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bytes", nbytes), ("ops", ops)):
            tot[k] += NORMS_PER_SHAPE * v
        del xf, x, xhat, dy, fx, fy
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"], peaks)
    print(f"  sums one train step (30 launches): kernel {tot['ms']:.4f} ms "
          f"plain {tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms",
          flush=True)
    return tot


# -- phase 9: the training step --------------------------------------------------

def train_batch(seed: int, b: int, h: int, w: int, dev):
    """Uniform images and a smooth flow with |flow| < 50 px, all valid."""
    import torch
    g = torch.Generator().manual_seed(seed)
    i1 = torch.rand(b, h, w, 3, generator=g) * 255
    i2 = torch.rand(b, h, w, 3, generator=g) * 255
    yy, xx = torch.meshgrid(torch.linspace(0, math.pi, h),
                            torch.linspace(0, 2 * math.pi, w), indexing="ij")
    amp = torch.rand(b, 1, 1, 2, generator=g) * 25 + 5
    flow = amp * torch.stack([torch.sin(xx + yy), torch.cos(2 * yy - xx)],
                             -1)[None]
    return tuple(t.to(dev) for t in (i1, i2, flow, torch.ones(b, h, w)))


def make_trainer(dev, mode: str, mixed: bool, iters: int, seed: int = 0):
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.train import make_optimizer, make_train_step
    model = build_model(dev, seed=seed, mixed_precision=mixed)
    opt, sched = make_optimizer(model.parameters(), TRAIN_LR, TRAIN_NUM_STEPS)
    return model, make_train_step(model, opt, sched, iters=iters,
                                  grad_mode=mode)


def grads_of(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def grad_floor(name: str, total: float) -> float:
    """The least norm a gradient tensor's relative difference is taken
    against: ``ZERO_GRAD_FLOOR`` of the global norm for the fnet conv
    biases in front of an instance norm (zero in exact arithmetic), 1e-6
    of it for every other tensor."""
    zero = (name.startswith("fnet.") and name.endswith(".bias")
            and name != "fnet.conv2.bias")
    return (ZERO_GRAD_FLOOR if zero else 1e-6) * total


def phase_train(dev):
    import torch
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    batches = [train_batch(10 + i, TRAIN_B, H, W, dev)
               for i in range(TRAIN_STEPS + 1)]
    out = {}
    for mode in ("standard", "taped"):
        model, step = make_trainer(dev, mode, True, ITERS)
        per = 2 * LEVELS * (ITERS if mode == "standard" else 1)
        want = forward_counts(dccl_level_lookup=LEVELS * ITERS,
                              instance_norm_sums=30, dccl_grid_coords=per,
                              dccl_level_scatter=per)
        times, losses, norms, counts = [], [], [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches):
            reset_launch_counts()
            t0 = time.perf_counter()
            m = step(batch, i)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            counts = launch_counts()
            if counts != want:
                fail(f"train {mode} step {i}: launch counts {counts}, "
                     f"expected {want}")
            loss, gn = float(m["train/loss"]), float(m["train/grad_norm"])
            if not (math.isfinite(loss) and math.isfinite(gn)):
                fail(f"train {mode} step {i}: loss {loss}, grad norm {gn}")
            if i == 0:
                out[mode + "_first"] = (loss, grads_of(model))
            else:
                times.append(dt)
            losses.append(loss)
            norms.append(gn)
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = statistics.median(times)
        print(f"  train {mode} {H}x{W} batch {TRAIN_B} iters {ITERS} bf16: "
              f"launches/step {counts}; median {med:.1f} ms/step over "
              f"{len(times)} after one warm-up (min {min(times):.1f}, max "
              f"{max(times):.1f}); peak {peak:.2f} GB",
              flush=True)
        print(f"    loss per step {[round(v, 4) for v in losses]}", flush=True)
        print(f"    grad norm per step {[round(v, 4) for v in norms]}",
              flush=True)
        out[mode] = dict(ms=med, peak_gb=peak, counts=counts, losses=losses,
                         norms=norms)
        del model, step
        torch.cuda.empty_cache()

    # standard against taped: same weights and batch at the first step
    (l_s, g_s), (l_t, g_t) = out["standard_first"], out["taped_first"]
    if abs(l_s - l_t) > STEP_LOSS_RTOL * abs(l_s):
        fail(f"standard and taped losses differ: {l_s} vs {l_t}")
    total = math.sqrt(sum(float((a.double() ** 2).sum()) for a in g_s.values()))
    worst = 0.0
    for n, a in g_s.items():
        rel = ((a - g_t[n]).norm()
               / max(a.norm().item(), grad_floor(n, total))).item()
        worst = max(worst, rel)
        if rel > MODE_GRAD_RTOL:
            fail(f"standard and taped gradients differ on {n}: {rel:.3e}")
    print(f"  standard vs taped, first step: loss {l_s:.6f} vs {l_t:.6f}; "
          f"worst per-tensor relative L2 gradient difference {worst:.3e} "
          f"(gate {MODE_GRAD_RTOL})", flush=True)
    out["mode_worst"] = worst
    return out


def profile_train_step(dev, mode: str):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, step = make_trainer(dev, mode, True, ITERS)
    batch = train_batch(99, TRAIN_B, H, W, dev)
    step(batch, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ours = {k: sum(e.self_device_time_total for e in events if k in e.key)
            / 1e3 for k in PORT_KERNELS}
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"  profile train {mode}: wall {wall:.1f} ms (profiled), device busy "
          f"{busy:.1f} ms ({100 * busy / wall:.1f}%); port kernels "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items()), flush=True)
    for e in events[:25]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


# -- phase 10: the train step on the card against the CPU ------------------------

def phase_train_card_vs_cpu(dev):
    import torch
    worst = {}
    for mode in ("standard", "taped"):
        res = {}
        for d in (torch.device("cpu"), dev):
            model, step = make_trainer(d, mode, False, 2, seed=3)
            m = step(train_batch(5, 1, 128, 256, d), 0)
            res[d.type] = (float(m["train/loss"]),
                           {n: p.grad.detach().cpu() for n, p in
                            model.named_parameters()})
        (l_c, g_c), (l_g, g_g) = res["cpu"], res["cuda"]
        if abs(l_g - l_c) > STEP_LOSS_RTOL * abs(l_c):
            fail(f"train {mode}: card loss {l_g} vs CPU {l_c}")
        total = math.sqrt(sum(float((t.double() ** 2).sum())
                              for t in g_c.values()))
        worst[mode] = (0.0, "")
        for n, ref in g_c.items():
            rel = ((g_g[n] - ref).norm()
                   / max(ref.norm().item(), grad_floor(n, total))).item()
            if rel > CARD_CPU_GRAD_RTOL:
                fail(f"train {mode}: card and CPU gradients differ on {n}: "
                     f"{rel:.3e} > {CARD_CPU_GRAD_RTOL}")
            worst[mode] = max(worst[mode], (rel, n))
        print(f"  train {mode} 128x256 iters 2 f32: loss card {l_g:.6f} CPU "
              f"{l_c:.6f}; worst gradient rel L2 {worst[mode][0]:.3e} "
              f"({worst[mode][1]}; gate {CARD_CPU_GRAD_RTOL})", flush=True)
    return worst


# -- phase 11: the lookup at given cross coords, 1024x2048 ----------------------

def given_coords(cen, grid, scale):
    """The planes route's cross tap coords at one level (the coords kernel
    at the pre-scaled centres), as (B, Q, 81) planes."""
    from prior_flow_tpu_torch.ops.corr import cross_coords_all_levels
    B, Q, _ = cen.shape
    return [c.reshape(B, Q, 81)
            for c in cross_coords_all_levels(cen, grid, [scale])]


def phase_lookup_coords(dev, grids2, peaks):
    """Row 3 against its plain version and against kernel 1, bitwise, at the
    four level shapes of a 1024x2048 forward (B x Q = 32768), f32 and bf16;
    one bf16 level-0 launch at batch 3 (more than 2^31 volume elements).
    Times per iteration (4 levels): row 3, kernel 1, the planes route's two
    coords launches, the plain version and 4 F.grid_sample per level."""
    import torch
    from prior_flow_tpu_torch.ops.corr import cross_coords_all_levels
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        NTAP, dccl_level_lookup, dccl_level_lookup_coords,
        dccl_level_lookup_coords_plain)

    rows = {}
    scales = [1.0 / 2 ** lvl for lvl in range(LEVELS)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                   err=0.0, grid_route_ms=0.0)
        for lvl, s in enumerate(scales):
            vA, vB, cA, cB, gA, gB = lookup_inputs(lvl, dtype, dev, grids2,
                                                   size=(H2, W2))
            with torch.no_grad():
                given = given_coords(cA, gA, s) + given_coords(cB, gB, s)
                args = (vA, vB, cA, cB, s, *given)
                got = dccl_level_lookup_coords(*args)
                ref = dccl_level_lookup_coords_plain(*args)
                k1 = dccl_level_lookup(vA, vB, cA, cB, gA, gB, s)
                torch.cuda.synchronize()
                for name, other in (("its plain version", ref),
                                    ("kernel 1", k1)):
                    if not all(torch.equal(a, b) for a, b in zip(got, other)):
                        err = max((a - b).abs().max().item()
                                  for a, b in zip(got, other))
                        fail(f"lookup at given coords {tag} level {lvl} "
                             f"1024x2048: not bitwise equal to {name} (max "
                             f"abs err {err})")
                ms = cuda_ms(lambda: dccl_level_lookup_coords(*args), 20)
                k1_ms = cuda_ms(lambda: dccl_level_lookup(vA, vB, cA, cB, gA,
                                                          gB, s), 20)
                plain_ms = cuda_ms(lambda: dccl_level_lookup_coords_plain(
                    *args), 3, warmup=1)
                coords = lookup_sample_coords(cA, cB, gA, gB, s)
                BQ = vA.shape[1]
                nbytes, sectors = lookup_bytes(vA, vB, coords,
                                               4 * BQ * NTAP * 4)
                ops = BQ * NTAP * LOOKUP_COORDS_OPS_PER_TAP
                b_ms, _ = bound(nbytes, ops, peaks)
                library = grid_sample_library(vA, vB, coords)
                lib_ms = (cuda_ms(library, 10) if dtype == torch.float32
                          and library is not None else 0.0)
            print(f"  lookup at given coords {tag} level {lvl} "
                  f"({BQ}x{vA.shape[2]}x{vA.shape[3]}): bitwise equal to "
                  f"plain and to kernel 1; kernel {ms:.4f} ms  kernel 1 "
                  f"{k1_ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({sectors} sectors, "
                  f"{nbytes / 1e6:.2f} MB)", flush=True)
            for k, v in (("ms", ms), ("grid_route_ms", k1_ms),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes", nbytes), ("ops", ops)):
                tot[k] += v
            del vA, vB, args, got, ref, k1, coords, library
            torch.cuda.empty_cache()
        # the planes route's coords: one launch per branch, all levels
        cen = lookup_inputs(0, torch.float32, dev, grids2, size=(H2, W2))[2]
        with torch.no_grad():
            tot["coords_ms"] = 2 * cuda_ms(lambda: cross_coords_all_levels(
                cen, grids2.a2b_w2c_8, scales), 20)
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"],
                                                 peaks)
        rows[tag] = tot
        print(f"  {tag} one 1024x2048 iteration: planes route {tot['ms']:.4f} "
              f"(4 lookups) + {tot['coords_ms']:.4f} (2 coords launches) = "
              f"{tot['ms'] + tot['coords_ms']:.4f} ms; grid route (kernel 1, "
              f"4 launches) {tot['grid_route_ms']:.4f} ms; bound "
              f"{tot['bound_ms']:.4f} ms", flush=True)

    # 64-bit offsets: a bf16 level-0 batch of 3 x 32768 queries has
    # 3.2e9 > 2^31 elements per volume
    vA, vB, cA, cB, gA, gB = lookup_inputs(0, torch.bfloat16, dev, grids2,
                                           BIG_B, size=(H2, W2))
    with torch.no_grad():
        given = given_coords(cA, gA, 1.0) + given_coords(cB, gB, 1.0)
        got = dccl_level_lookup_coords(vA, vB, cA, cB, 1.0, *given)
        torch.cuda.synchronize()
        for b in (0, BIG_B - 1):
            one = lambda t: t[b:b + 1]
            ref = dccl_level_lookup_coords_plain(
                one(vA), one(vB), one(cA), one(cB), 1.0, *map(one, given))
            if not all(torch.equal(one(a), r) for a, r in zip(got, ref)):
                fail(f"lookup at given coords, bf16 level 0, batch {BIG_B} "
                     f"({vA.numel()} elements per volume): batch element {b} "
                     f"differs from the plain version")
    print(f"  lookup at given coords bf16 level 0 batch {BIG_B} "
          f"({vA.numel()} elements per volume, > 2^31): batch elements 0 and "
          f"{BIG_B - 1} bitwise equal to the plain version", flush=True)
    del vA, vB, given, got, ref
    torch.cuda.empty_cache()
    return rows


# -- phase 12: all levels in one launch ------------------------------------------

def phase_all_levels(dev, grids, peaks):
    """Row 4 against four per-level kernel-1 launches, bitwise, at 512x1024,
    batch 1 and 4, f32 and bf16; times of both, and at batch 1 f32 the
    plain version, the bound and 16 F.grid_sample."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        NTAP, dccl_level_lookup, dccl_lookup_all_levels,
        dccl_lookup_all_levels_plain)

    scales = [1.0 / 2 ** lvl for lvl in range(LEVELS)]
    row = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
               err=0.0)
    for b in (1, TRAIN_B):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            ins = [lookup_inputs(lvl, dtype, dev, grids, b)
                   for lvl in range(LEVELS)]
            cA, cB, gA, gB = ins[0][2:]
            vAs, vBs = [i[0] for i in ins], [i[1] for i in ins]
            args = (vAs, vBs, cA, cB, gA, gB, scales)
            per_level = lambda: [dccl_level_lookup(vAs[lvl], vBs[lvl], cA, cB,
                                                   gA, gB, scales[lvl])
                                 for lvl in range(LEVELS)]
            with torch.no_grad():
                got = dccl_lookup_all_levels(*args)
                ref = per_level()
                torch.cuda.synchronize()
                for lvl in range(LEVELS):
                    if not all(torch.equal(a, r)
                               for a, r in zip(got[lvl], ref[lvl])):
                        fail(f"all-levels lookup {tag} batch {b}: level {lvl} "
                             f"differs from its per-level launch")
                ms = cuda_ms(lambda: dccl_lookup_all_levels(*args), 20)
                per_ms = cuda_ms(per_level, 20)
                if b == 1 and dtype == torch.float32:
                    row["ms"], row["per_level_ms"] = ms, per_ms
                    row["plain_ms"] = cuda_ms(
                        lambda: dccl_lookup_all_levels_plain(*args), 3,
                        warmup=1)
                    for lvl in range(LEVELS):
                        coords = lookup_sample_coords(cA, cB, gA, gB,
                                                      scales[lvl])
                        nbytes, _ = lookup_bytes(vAs[lvl], vBs[lvl], coords, 0)
                        row["bytes"] += nbytes
                        row["ops"] += cA.shape[1] * NTAP * LOOKUP_OPS_PER_TAP
                        library = grid_sample_library(vAs[lvl], vBs[lvl],
                                                      coords)
                        if library is not None:
                            row["library_ms"] += cuda_ms(library, 20)
                    row["bytes"] += 2 * gA.numel() * 4
            print(f"  all-levels lookup {tag} batch {b}: bitwise equal to 4 "
                  f"per-level launches; one launch {ms:.4f} ms, 4 launches "
                  f"{per_ms:.4f} ms", flush=True)
            del ins, vAs, vBs, args, got, ref
            torch.cuda.empty_cache()
    row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"], peaks)
    print(f"  all-levels f32 batch 1: plain {row['plain_ms']:.4f} ms, "
          f"16 F.grid_sample {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms", flush=True)
    return row


# -- phase 13: the chunked pyramid build -----------------------------------------

def phase_pyramid_lean(dev):
    """build_pyramid_lean against the dense build cast per level, at
    512x1024 and 1024x2048, f32 and bf16: bitwise expected; otherwise the
    worst difference is reported and held to 2^-20 of max|level| (f32) or
    one bf16 step. ms and peak GB (outputs included) of each build."""
    import torch
    from prior_flow_tpu_torch.ops.corr import (all_pairs_correlation,
                                               build_pyramid,
                                               build_pyramid_lean)
    out = {}
    for h, w in ((H, W), (H2, W2)):
        g = torch.Generator(device=dev).manual_seed(h)
        f1, f2 = (torch.randn(1, h // 8, w // 8, 256, generator=g, device=dev)
                  for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{h}x{w} {'f32' if dtype == torch.float32 else 'bf16'}"
            dense_fn = lambda: [p.to(dtype).contiguous() for p in build_pyramid(
                all_pairs_correlation(f1, f2), LEVELS)]
            lean_fn = lambda: build_pyramid_lean(f1, f2, LEVELS, dtype)
            res, peak = {}, {}
            with torch.no_grad():
                for name, fn in (("lean", lean_fn), ("dense", dense_fn)):
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    res[name] = fn()
                    torch.cuda.synchronize()
                    peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
                worst = 0.0
                for lvl, (a, d) in enumerate(zip(res["lean"], res["dense"])):
                    if torch.equal(a, d):
                        continue
                    diff = (a.float() - d.float()).abs()
                    worst = max(worst, diff.max().item())
                    if dtype == torch.float32:
                        ok = diff.max().item() <= 2.0 ** -20 * d.abs().max().item()
                    else:
                        ok = bool((diff <= 2.0 ** -7 * d.float().abs()).all())
                    if not ok:
                        fail(f"lean build {tag} level {lvl}: max abs diff "
                             f"{diff.max().item()} from the dense build")
                del res
                torch.cuda.empty_cache()
                lean_ms = cuda_ms(lean_fn, 3, warmup=1)
                dense_ms = cuda_ms(dense_fn, 3, warmup=1)
            torch.cuda.empty_cache()
            verdict = "bitwise equal" if worst == 0.0 else f"max abs diff {worst:.3e}"
            print(f"  pyramid {tag}: lean {verdict} to dense; lean {lean_ms:.3f} "
                  f"ms, peak {peak['lean']:.2f} GB; dense {dense_ms:.3f} ms, "
                  f"peak {peak['dense']:.2f} GB", flush=True)
            out[tag] = dict(lean_ms=lean_ms, dense_ms=dense_ms, worst=worst,
                            lean_gb=peak["lean"], dense_gb=peak["dense"])
        del f1, f2
    return out


# -- phase 14: the 1024x2048 forward, forced routes, fused levels ----------------

def phase_forward_hr(dev, ref_128, flow32, c1, c2, i1, i2):
    """The 1024x2048 test-mode forward (fp32, bf16) through build_model:
    48 lookups at given coords, 24 coords launches, no kernel 1; then the
    128x256 forward with the chunked build and the planes route forced on
    the card against the CPU's default routes; then the 512x1024 fp32
    forward with all levels in one launch (PRIORFLOW_DCCL_FUSE_LEVELS=1)
    against phase 4's flow."""
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.models import prior_raft
    from prior_flow_tpu_torch.ops.corr import DCCLFused
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    out = {}
    want = forward_counts(dccl_level_lookup_coords=LEVELS * ITERS,
                          dccl_grid_coords=2 * ITERS)
    h1, h2 = (t.to(dev) for t in images(2, H2, W2))
    for mixed in (False, True):
        tag = "bf16" if mixed else "fp32"
        model, flow, counts, ms, peak = phase_forward(dev, mixed, h1, h2,
                                                      want, runs=5)
        out[tag] = dict(ms=ms, peak_gb=peak, counts=counts, model=model)
        del flow

    # forced routes on the card against the CPU's default routes
    lean_at = prior_raft.LEAN_BUILD_QUERIES
    prior_raft.LEAN_BUILD_QUERIES = 0
    try:
        model = build_model(seed=0)
        model.dccl = DCCLFused(grid_in_kernel=False)
        reset_launch_counts()
        got = model(c1.to(dev), c2.to(dev), iters=4).cpu()
        counts = launch_counts()
    finally:
        prior_raft.LEAN_BUILD_QUERIES = lean_at
    forced = forward_counts(dccl_level_lookup_coords=4 * LEVELS,
                            dccl_grid_coords=2 * 4)
    if counts != forced:
        fail(f"forced planes + lean forward: launch counts {counts}, "
             f"expected {forced}")
    err = (got - ref_128).abs().max().item()
    scale = ref_128.abs().max().item()
    print(f"  128x256 iters 4 f32, chunked build + planes route on the card "
          f"vs default routes on the CPU: max abs err {err:.3e}, ratio "
          f"{err / scale:.3e} (gate {CARD_CPU_TOL})", flush=True)
    if not (torch.isfinite(got).all() and err <= CARD_CPU_TOL * scale):
        fail("forced routes on the card and the CPU's defaults disagree")
    out["forced_ratio"] = err / scale

    # all levels in one launch, selected as in JAX by the environment
    os.environ["PRIORFLOW_DCCL_FUSE_LEVELS"] = "1"
    try:
        model, flow, counts, ms, _ = phase_forward(
            dev, False, i1, i2,
            forward_counts(dccl_lookup_all_levels=ITERS), runs=5)
    finally:
        del os.environ["PRIORFLOW_DCCL_FUSE_LEVELS"]
    err = (flow - flow32).abs().max().item()
    scale = flow32.abs().max().item()
    print(f"  fused levels vs per-level fp32 flow at {H}x{W}: max abs diff "
          f"{err:.3e} (gate {FUSED_FLOW_TOL} x flow scale {scale:.3f})",
          flush=True)
    if err > FUSED_FLOW_TOL * scale:
        fail("the fused-levels forward departs from the per-level one")
    out["fused"] = dict(ms=ms, counts=counts, diff=err)
    del model, flow
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of one forward")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    try:
        import prior_flow_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    from prior_flow_tpu_torch.geometry import rotation_grids
    from prior_flow_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
          f"TF32 off for matmuls and convolutions; peaks used for bounds: "
          f"{peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s f32",
          flush=True)

    t_start = t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"phase 1 build: {lib.build_seconds:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with load) -> {lib.path.name}",
          flush=True)
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    grids = rotation_grids(H, W).to_device(dev)
    print("phase 2 dccl lookup kernel vs plain", flush=True)
    lookup = phase_lookup(dev, grids, peaks)
    print("phase 3 instance-norm sums kernel vs plain", flush=True)
    sums = phase_sums(dev, peaks)

    print("phase 4 forward", flush=True)
    i1, i2 = (t.to(dev) for t in images(0, H, W))
    model32, flow32, counts, ms32, _ = phase_forward(dev, False, i1, i2)
    model16, flow16, counts16, ms16, _ = phase_forward(dev, True, i1, i2)
    diff = (flow16 - flow32).abs().max().item()
    print(json.dumps({"forward_ms_per_pair": {"fp32": ms32, "bf16": ms16},
                      "build_s": lib.build_seconds}))
    print(f"  bf16 vs fp32 max abs diff {diff:.4f} "
          f"(flow scale {flow32.abs().max().item():.3f}; reported, not gated)")
    if args.profile:
        profile_forward(model32, i1, i2, "fp32")
        profile_forward(model16, i1, i2, "bf16")
    del model16, flow16

    print("phase 5 card vs CPU, 128x256, 4 iterations, f32", flush=True)
    from prior_flow_tpu_torch import build_model
    c1, c2 = images(1, 128, 256)
    ref = build_model("cpu", seed=0)(c1, c2, iters=4)
    out = model32(c1.to(dev), c2.to(dev), iters=4).cpu()
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  max abs err {err:.3e}, flow scale {scale:.3f}, "
          f"ratio {err / scale:.3e} (gate {CARD_CPU_TOL})", flush=True)
    if not (torch.isfinite(out).all() and err <= CARD_CPU_TOL * scale):
        fail("card and CPU forwards disagree")

    print("phase 6 cross-tap-coords kernel vs plain", flush=True)
    coords = phase_coords(dev, grids, peaks)
    print("phase 7 volume-scatter kernel vs plain", flush=True)
    scatter = phase_scatter(dev, grids, peaks)
    print("phase 8 instance-norm sums of a train step", flush=True)
    sums_train = phase_sums_backward(dev, peaks)
    del model32
    torch.cuda.empty_cache()
    print(f"phase 9 train step, {H}x{W}, batch {TRAIN_B}, {ITERS} iterations, "
          f"bf16", flush=True)
    train = phase_train(dev)
    print(json.dumps({"train_ms_per_step": {m: train[m]["ms"] for m in
                                            ("standard", "taped")},
                      "train_peak_gb": {m: train[m]["peak_gb"] for m in
                                        ("standard", "taped")}}))
    if args.profile:
        for mode in ("standard", "taped"):
            profile_train_step(dev, mode)
    print("phase 10 train step, card vs CPU, 128x256, 2 iterations, f32",
          flush=True)
    phase_train_card_vs_cpu(dev)

    grids2 = rotation_grids(H2, W2).to_device(dev)
    print(f"phase 11 lookup at given cross coords vs plain and kernel 1, "
          f"{H2}x{W2}", flush=True)
    lookup_coords = phase_lookup_coords(dev, grids2, peaks)
    print("phase 12 all levels in one launch vs per-level launches",
          flush=True)
    all_levels = phase_all_levels(dev, grids, peaks)
    print("phase 13 chunked pyramid build vs dense", flush=True)
    pyramids = phase_pyramid_lean(dev)
    print(f"phase 14 forward {H2}x{W2}; forced routes vs CPU; fused levels",
          flush=True)
    hr = phase_forward_hr(dev, ref, flow32, c1, c2, i1, i2)
    print(json.dumps({"forward_1024x2048_ms_per_pair": {
        m: hr[m]["ms"] for m in ("fp32", "bf16")},
        "forward_1024x2048_peak_gb": {m: hr[m]["peak_gb"]
                                      for m in ("fp32", "bf16")},
        "forward_fused_levels_ms_per_pair": hr["fused"]["ms"],
        "pyramids": pyramids}))
    if args.profile:
        h1, h2 = (t.to(dev) for t in images(2, H2, W2))
        for m in ("fp32", "bf16"):
            profile_forward(hr[m]["model"], h1, h2, f"{H2}x{W2} {m}")

    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])

    std, tap = train["standard"]["counts"], train["taped"]["counts"]
    hr_counts, fused_counts = hr["fp32"]["counts"], hr["fused"]["counts"]
    per_path = ("launches: one run of the path in launches_path; "
                "launches_train / launches_taped: one standard / taped train "
                "step (512x1024, batch 4, 12 iterations, bf16); "
                "launches_forward: one 512x1024 test-mode forward; "
                "launches_forward_1024x2048: one 1024x2048 forward; "
                "launches_forward_fused_levels: one 512x1024 forward with "
                "PRIORFLOW_DCCL_FUSE_LEVELS=1")

    def row(name, src, replaces, d, work, err, path="train"):
        paths = {"train": std, "forward_1024x2048": hr_counts,
                 "forward_fused_levels": fused_counts}
        return {"name": name, "route": "cuda",
                "source": f"prior_flow_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": paths[path][name],
                "launches_path": path, "launches_train": std[name],
                "launches_taped": tap[name],
                "launches_forward": counts.get(name, 0),
                "launches_forward_1024x2048": hr_counts[name],
                "launches_forward_fused_levels": fused_counts[name],
                "max_abs_err": err, "ms": d["ms"], "plain_ms": d["plain_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "library_ms": d["library_ms"], "work": work + "; " + per_path}

    lk = lookup["f32"]
    kernels = [
        row("dccl_level_lookup", "dccl_lookup.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:239", lk,
            "ms/plain/bound/library: one GRU iteration, 4 level launches, f32 "
            "volumes, 512x1024, batch 1; library_ms = 4 F.grid_sample per "
            "level at precomputed cross coords (leaves out the grid-window "
            "stage)", max(lk["err"], lookup["bf16"]["err"])),
        row("instance_norm_sums", "instance_norm.cu",
            "prior_flow_tpu/ops/pallas/instance_norm.py:52", sums_train,
            "ms/plain/bound/library: one batch-4 train step's 30 sums, 15 "
            "forward (x, x) bf16 and 15 backward (xhat, dy) f32 at B = 16; "
            "library_ms = torch.var_mean(x) + torch.linalg.vecdot(xhat, dy) "
            "(leaves out sum(dy))", max(sums_train["err"], sums["f32"]["err"],
                                        sums["bf16"]["err"])),
        row("dccl_grid_coords", "dccl_coords.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:1033", coords,
            "ms/plain/bound/library: one taped step's 8 launches, N = 393216 "
            "centres each; library_ms = F.grid_sample of the grid at "
            "precomputed normalised window coords (leaves out the window and "
            "the wrap)", coords["err"]),
        row("dccl_level_scatter", "dccl_scatter.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:715 (_scatter_own_cross; "
            "stacked: :1108, :1152)", scatter,
            "ms/plain/bound/library: one taped step's 8 launches, S = 12, "
            "batch 4, bf16 output; library_ms = index_put_(accumulate=True) "
            "of the precomputed weighted corners into f32 (leaves out the "
            "corners, the zeroing and the cast); one standard step's 96 S=1 "
            f"launches: {scatter['standard_step_ms']:.4f} ms", scatter["err"]),
        row("dccl_level_lookup_coords", "dccl_lookup.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:314",
            lookup_coords["f32"],
            "ms/plain/bound/library: one GRU iteration of the 1024x2048 "
            "forward, 4 level launches at given coords, f32 volumes, batch 1 "
            "(B x Q = 32768); library_ms = 4 F.grid_sample per level at the "
            "given coords; the route's 2 coords launches per iteration: "
            f"{lookup_coords['f32']['coords_ms']:.4f} ms; kernel 1 at the "
            f"same shapes: {lookup_coords['f32']['grid_route_ms']:.4f} ms",
            max(lookup_coords["f32"]["err"], lookup_coords["bf16"]["err"]),
            path="forward_1024x2048"),
        row("dccl_lookup_all_levels", "dccl_lookup.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:271", all_levels,
            "ms/plain/bound/library: one GRU iteration at 512x1024, batch 1, "
            "f32, one launch for 4 levels; library_ms = 16 F.grid_sample at "
            "precomputed coords (leaves out the grid-window stage); 4 "
            f"per-level launches: {all_levels['per_level_ms']:.4f} ms",
            all_levels["err"], path="forward_fused_levels"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
