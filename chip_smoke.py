#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --multichip     # on a host with 2+ cards

Phases, each fatal on failure (non-zero exit, no result line):
1. build the CUDA kernels from ``prior_flow_tpu_torch/csrc``;
2. the DCCL level-lookup kernel against its plain version at the four
   pyramid-level shapes of a 512x1024 forward (batch 1) and of the batch-4
   training step (B x Q = 32768 queries), f32 and bf16 volumes, and at the
   512x1024 shapes bitwise against row 3 fed the coords kernel's coords;
   its time and its library yardstick's both issued back to back and
   queued; the grid-route DCCLFused call per iteration, both ways;
3. the instance-norm sums kernel against its plain version at the three
   fnet shapes, f32 and bf16;
4. the test-mode forward at 512x1024, batch 1, 12 iterations, seeded
   random weights, fp32 then mixed precision: output shape, finiteness,
   launch counts per forward (48 lookups, 15 norms), median ms/pair;
5. the same weights on the card and on the CPU at 128x256, 4 iterations;
   then, at torch's default flags (TF32 on for cuDNN convolutions),
   build_model() (error reported) and build_model(precision="highest")
   (gated) against the same CPU forward;
6. the cross-tap-coords kernel where the main paths launch it, the planes
   route of the 1024x2048 forward (per iteration one launch for both
   branches and N = 4 levels x 32768 centres): bitwise against its plain
   version, ms per forward (12 launches) issued back to back and queued;
   the same call at the 512x1024 level shapes, batch 1 and 4, bitwise, the
   one-branch entry bitwise equal to it, and the lookup kernel's cross
   taps bitwise equal to the plain sampler of the other volume at these
   coords;
7. the volume scatter's two entries (grid, given coords) against their
   plain versions and against each other at the training level shapes
   (B = 4), S = 1 and 12, f32 and bf16 output; per taped and standard
   step, each beside its bound;
8. the instance-norm sums of a batch-4 step, forward (x, x) in bf16 and
   backward (xhat, dy) in f32 with a zero-mean dy, at the three fnet shapes
   (B = 16), within the rounding of an f64-accumulated sum;
9. the training step at the EFT recipe: 512x1024, batch 4, 12 iterations,
   bf16 autocast, AdamW + OneCycle + clip 1.0, seeded weights and batches,
   both grad modes: launch counts per step, loss and grad norm of each
   step, median ms/step, peak GB; standard and taped agree on the first
   step's loss and gradients;
10. one step on the card and on the CPU at 128x256, batch 1, 2 iterations,
   f32, both grad modes, same weights; and a standard step with the planes
   route forced on the card (one coords launch per iteration, the
   scatter's given-coords entry);
11. the lookup at given cross coords against its plain version and against
   the grid lookup (kernel 1), bitwise, at the four level shapes of a
   1024x2048 forward (B x Q = 32768), f32 and bf16, with the coords from
   the coords kernel (the planes route); one bf16 level-0 launch at batch
   3 (more than 2^31 volume elements) checked on its first and last batch
   element; per iteration the ms of row 3, of kernel 1 at these shapes and
   of the coords launch, issued back to back and queued;
12. the all-levels lookup against four per-level launches, bitwise, at
   512x1024, batch 1 and 4, f32 and bf16, each timed issued back to back
   and queued;
13. the chunked pyramid build against the dense one at 512x1024 and
   1024x2048, f32 and bf16 (bitwise expected; else gated at 2^-20 of
   max|level| in f32 and one bf16 step), ms and peak GB of each;
14. the 1024x2048 test-mode forward, batch 1, 12 iterations, fp32 then bf16
   (48 lookups at given coords, 12 coords launches, no kernel 1, 15 norms
   per forward; median ms/pair over 5 runs; peak GB); the 128x256 forward
   with the chunked build and the planes route forced on the card against
   the CPU's default routes; the 512x1024 fp32 forward with
   PRIORFLOW_DCCL_FUSE_LEVELS=1 (12 all-levels launches, no kernel 1) within
   1e-5 x flow scale of phase 4's flow;
15. the primitive-rate anchors (``tools/microbench_vpu_anchor.py``) at the
   tool's size (128 x (512, 128) f32, K = 256): the gather's read schedule
   built once by the plan kernel and held bitwise against its plain
   version, the six (kind, ilp) chains (the gathers on that plan) bitwise
   against their plain versions, the SASS step instructions per element (K
   less at most one per chain, or the chain was folded), the card's ms and
   T elem-ops/s beside the operations bound from the SM count and the max
   SM clock (each gather's bytes bound counts its plan); the plan kernel's
   ms on its own and the shared-memory wavefronts per row-step modelled
   from idx (old layout, plan); the copy kernel bitwise 2x, its per-block
   slope from 512 to 4096 blocks, and one empty launch;
16. the DCCL stage split (``tools/microbench_kernel_split.py``) at 512x1024,
   batch 1, four levels, f32 and bf16, each stage kernel 1's column body
   with the other stages compiled out: own-only and cross-only bitwise equal
   to kernel 1's outputs, gridwin-only bitwise equal to two coords-kernel
   launches, each beside its plain version; per level the ms of kernel 1,
   of row 3 at random coords and of each stage beside its bytes bound;
17. the grid-window variants (``tools/microbench_gridwin.py``) at Q = 8192,
   64x128 grids, each on kernel 1's grid-window column body: both semantic
   variants (direct, the coords kernel's both-branch entry; smem_grid, the
   grids in shared memory) and the pair bitwise equal to two one-branch
   coords launches, the reads and arith diagnostics bitwise their plain
   versions; ms of each variant, diagnostic, the pair and the two
   launches, the plain version and F.grid_sample.
18. the evaluation path at 512x1024 on a seeded synthetic MPF test split
   (``EFTs_Car100`` and ``City_100_r``, 4 PNG frames and ``.flo`` ground
   truth each, written under ``build/phase18/`` by the port's writers)
   with a ``.pth`` of ``build_model(seed=0)``: ``cli.evaluate`` dense,
   ``--regions`` and ``City100`` (24 iterations) on the card, each gated
   on finite metrics and on the launches of phase 4's forward per pair
   (kernel 1 four per iteration, the sums 15), nothing else; the 128x256
   twin's dense and regions metrics on the card against ``--device cpu``
   (relative 1e-3); batch 2 against batch 1 (relative 1e-5); an oracle
   model (EPE < 1e-5, SEPE < 1e-4); ``cli.video --warm_start`` (finite
   ``.flo`` files) and ``cli.demo_image`` (its PNG reads back); the
   native host library built into ``build/`` and held to numpy; the
   loop's ms per pair beside phase 4's and its stages (read, pad,
   forward, metrics);
19. the training CLI (``cli.train``, in-process) at the EFT recipe on a
   seeded synthetic MPF training tree written under ``build/phase19/``
   (``EFTs_Car2000``, 9 frames at 512x1024, 2 batches of 4 per epoch, so
   an epoch boundary falls inside the run; ``EFTs_Car100``, 4 frames, for
   ``--validation EFT``): ``--mixed_precision --num_steps 5 --val_freq 3
   --add_noise``, each grad mode: the launches of 6 steps, 2 validations of
   3 pairs and one image panel forward, finite losses and validation
   metrics, checkpoint tags 3, 6 and final, the model in train mode after
   validation; ``cli.evaluate`` on ``final/model.pth``; a run resumed
   from tag 3 within ``RESUME_RTOL`` of the uninterrupted one; the seeded
   weights through a ``module.``-prefixed ``.pth`` and
   ``--restore_ckpt`` (step 0's loss is the seeded run's); the loop's ms
   per step on the card's clock beside phase 9's bare step, the loader's
   wait per step, its host ms per batch at 1 and 4 workers, peak GB.
20. serving (``prior_flow_tpu_torch.serving``): ``torch.library.opcheck``
   of each priorflow:: op on the card (the lookup per level and fused at
   the 512x1024 level shapes, row 3 at level 0 of 512x1024 and 1024x2048,
   the coords at both sizes, the sums at the first fnet norm's shape, f32
   and bf16); at 512x1024, batch 1, 12 iterations, fp32
   ``precision="highest"`` and bf16: the exported program saved, loaded
   and run in a process that never imports the model code (within 1e-5 of
   eager, 48 kernel-1 and 15 sums launches per call), the AOTInductor
   package (``serving.aot_compile``, loaded from its file alone; each
   precision compiled at 12 iterations and at one, the four side by side
   in processes of their own, started before phase 18 so that phases 18
   and 19 and the other checks run while they compile; compile
   seconds), called with TF32 on for cuDNN (torch's default) with seed 0's
   and seed 1's states: each strictly below a fraction of the distance one
   step down in precision puts eager from itself (``SERVING_GATE``), the
   fp32 one at one iteration also within 1e-3 x flow scale; exactly 4
   kernel-1 launches per iteration and 15 sums per call; at 12 iterations
   every convolution kernel of one profiled call of the precision by its
   name (fp32 none TF32, bf16 all bf16; TF32 eager the control), bitwise
   the same on a side stream, batch, dtype and device drift raise; ms/pair
   of eager, exported program and package (median of 7 after one warm-up,
   after the compiles); the 1024x2048 forward as an exported program,
   bitwise eager, 12 coords and 48 row-3 launches per call;
   ``cli.export --check`` on a seeded ``.pth``.
21. the memory-scale modes: (a) one ``DCCLOnTheFly`` call against
   ``DCCLFused``'s fields at 1024x2048 on the same seeded fmaps and centres
   (f32 chunked build; 2 coords launches), the plain on-the-fly tap path
   alone at 2048x4096 (ms per 12-iteration forward beside its bound: f1
   and each tap window's distinct feature rows read once), and the
   1024x2048 fp32 ``precision="highest"`` forward on the fly against the
   volume route (3 iterations gated at JAX's contract, 12 reported); (b)
   the 2048x4096 bf16 forward, batch 1, 12 iterations, on the fly:
   finite flow, 15 sums and 96 coords launches, peak GB, ms/pair, beside
   the 91.27 GB the volume route's bf16 pyramids would take; (c) the EFT
   step (phase 9's recipe) in both grad modes with remat off, ``dccl``
   and ``dots``: peak GB, ms/step, the launches of no remat (no lookup
   replayed), the first step's loss and gradients against no remat's
   within twice the distance between two no-remat steps; (d) one
   standard step at 512x1024, batch 1, 12 iterations, fp32, remat
   ``dccl``, on the fly against the volume route.
22. data parallel on one card (``prior_flow_tpu_torch.parallel``): (a)
   ``Trainer.run`` for 2 updates at the EFT recipe on a one-rank NCCL
   mesh (``file://`` rendezvous) against the run without a mesh: the
   first update's metrics bitwise, the parameters bitwise (or, where two
   runs without a mesh differ, the scatter's atomics, within twice their
   distance); the gradient all-reduce's ms and bytes; (b) two spawned
   ranks sharing the card over gloo, a global batch of 2, fp32
   ``precision="highest"``, 12 iterations, standard and taped: each
   rank's all-reduced gradients before the clip and the loss against one
   process summing the two ranks' shares (bitwise, or within twice the
   distance of two such sums) and against the batch-2 step (per tensor
   within twice the sum's distance from it plus 2e-4 of its norm), both
   ranks' gradients and parameters bitwise equal, per rank ms/step, peak
   GB and launches; the same two ranks, a data-only mesh, take the
   ``bn_running_average=False`` step at 64x128, 1 iteration, against
   one process's step on the global batch as phase 25 (a)'s gates hold a
   step (the statistics summed over both ranks: running statistics
   within 1e-4 of one process's and bitwise the same on both ranks);
   two NCCL ranks on the one card fail; (c)
   ``dryrun_multichip(2)`` on the card over gloo. The NCCL refusal and
   (c) run while (b) does.
23. ``lookup_mode`` mxu and gather (``ops.corr.DCCL``, no kernel): one
   DCCL call at 512x1024 against the kernel route's fields (1e-5 of
   max|field|), timed; the 512x1024 fp32 forward against the kernel
   route at 1 and 3 iterations (1e-4 x flow scale + 1e-4), 12 reported,
   ms/pair and peak GB; the mxu model exported on the card for cuda and
   cpu at 64x128, 1 iteration, run on both within 1e-5 of eager.
24. (a) deferred volume gradients (``PriOrRAFT(deferred_vol_grad=True)``,
   standard grad mode) at phase 9's EFT recipe, weights and batches: 48
   lookups (the recording pass), 30 sums and 8 stacked scatters per step,
   no per-iteration scatter; the first step's loss against phase 9's
   standard step, its gradients against phase 9's taped step (the same
   stacked scatter: within twice the distance of two taped steps plus
   1e-5 of each norm) and its standard step (phase 9's standard-vs-taped
   gate; the distance of two standard steps reported); median ms/step of
   5 after a warm-up and peak GB beside phase 9's; one fp32
   ``precision="highest"`` step at 128x256, 2 iterations, against the
   port's CPU deferred step (phase 10's gates); (b) the legacy ``RAFT``,
   basic (hidden 128, context 128, fnet 256) and small (96 / 64 / 128),
   4 levels, radius 4, a 440x1024 pair (a Sintel frame padded to /8),
   batch 1, 12 iterations: fp32 ``precision="highest"`` against the
   port's CPU within 1e-4 x max|flow|, the sums' launches per forward (15
   basic, 21 small) and nothing else, fp32 and bf16 ms/pair; (c)
   ``bn_running_average=False`` (PriOrRAFT, basic RAFT), a 64x128
   forward on the card against the CPU: the flow and the context
   encoder's updated running statistics. Each phase prints its seconds.
25. the space axis (``parallel/spatial.py``: height sharding) with ranks
   sharing the card over gloo: the sums kernel's f64 output (the
   sharded norm's partial sums) against its plain version at the
   1024x2048 fnet shapes' half heights; (a) a 1x2 data x space mesh, the
   EFT recipe's step at 512x1024, global batch 2, fp32
   ``precision="highest"``, remat ``dccl``, in the standard grad mode (2
   updates, the second timed), the taped mode and with
   ``deferred_vol_grad=True`` (1 update each), each at 12 iterations and
   at 1, against the one-process batch-2 step of the same mode in this
   process (loss within 1e-5, each gradient tensor within 1e-5 of its
   norm or twice the distance of two one-process steps and of the steps
   on images nudged by one rounding, the updated parameters within
   1e-5; launches per rank of rows 1, 2 and the scatter); (b) a 1x2
   mesh, the 1024x2048 fp32 test-mode forward (the lean build, the
   planes route: rows 3 and 5) within 1e-4 x flow scale of the
   one-process forward at 3 iterations (at 12 within twice the nudged
   pair's distance), each rank's peak GB beside one process's; (c)
   ``dryrun_multichip(4)`` on a 2x2 mesh; (d) a 1x2 mesh, the fp32
   forwards with ``lookup_mode`` ``mxu`` and ``gather`` at 512x1024, 3
   iterations, and the legacy RAFT basic and small at RAFT's published
   440x1024 (H / 8 = 55: strips of 224 and 216 rows, the second padded),
   12 iterations, each against one process (1e-4 x flow scale, at 12
   iterations or twice the nudged pair's distance; the sums' launches
   only), PriOr-RAFT at 520x1040 (H / 8 = 65: 264 + 256 rows; the planes
   route) in the test-mode forward at 3 iterations (1e-4 x flow scale)
   and one standard step at global batch 2, 1 iteration, as (a)'s, each
   with its peak GB per rank beside one process's, and the
   ``bn_running_average=False`` step at 64x128 as (a)'s at 1 iteration
   and on the distance over all tensors at 12 (its running statistics
   within 1e-4 and the same on both ranks); (a) beside (b) then (d)
   beside (c); the exchange route printed.
The launches of phases 15-17 are the tools' measurement runs (path
"tool"). Then the card's name and power limit, a ``kernels`` JSON line with each
kernel's launches per path, error, times and bound, and the result line.

TF32 is off for matmuls and cuDNN convolutions in every phase but the
precision check of phase 5, which runs at torch's defaults and puts the
setting back, so "fp32" is full f32 and the card-vs-CPU comparisons are
like for like.
``--profile`` adds a torch.profiler kernel breakdown of one forward per
precision (512x1024 and 1024x2048) and of one training step per grad
mode. ``--multichip`` runs instead only the data-parallel path on every
visible card (two or more), one rank per card over NCCL: phase 22 (b)'s
gates with n ranks and a global batch of max(2, n), then
``dryrun_multichip(n)`` (a 2 x n/2 data x space mesh where n is even and
at least 4) and ``cli.train --mesh auto`` at phase 19's recipe,
in-process (one spawned rank per card) and under ``torchrun``; with four
or more cards phase 25 (a), (b) and (d) on a 2 x n/2 NCCL mesh.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from prior_flow_tpu_torch.tools._timing import (  # noqa: E402
    cuda_ms, max_sm_clock_hz, nvidia_smi, queued_ms)

H, W, ITERS = 512, 1024, 12
FNET_SHAPES = [(4, 64, 256, 512), (4, 96, 128, 256), (4, 128, 64, 128)]
# the high-resolution path: a 1024x2048 pair, batch 1 (ROADMAP Queue 2
# items 4 and 5), and its fnet norm shapes
H2, W2 = 1024, 2048
FNET_SHAPES_HR = [(4, 64, 512, 1024), (4, 96, 256, 512), (4, 128, 128, 256)]
# and of the 2048x4096 pair (phase 21)
FNET_SHAPES_BIG = [(4, 64, 1024, 2048), (4, 96, 512, 1024),
                   (4, 128, 256, 512)]
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
# f32 operations per (centre, tap) of the coords kernel, counted from its
# column body: the tap's y 1, its y half of the corners 9 (floor, fraction,
# two rows, four bounds, the row-reuse test), the weights 6, the blend of two channels 14, and
# the column's shared x half (window 2, wrap 4, floor, fraction, two
# bounds each for two columns) 12 over its 9 taps; and per (s, query, tap)
# of the scatter's given-coords entry (window 4 + two corner sets 2 x 23 +
# eight weighted shared-memory adds 16)
COORDS_OPS_PER_TAP = 31
SCATTER_OPS_PER_TAP = 66
# the scatter's grid entry adds its cross taps' grid sample (47)
SCATTER_GRID_OPS_PER_TAP = SCATTER_OPS_PER_TAP + 47
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
                "dccl_coords_lookup_kernel", "dccl_cross_coords_kernel",
                "dccl_scatter_kernel", "row_sums_kernel")


def fail(msg: str) -> None:
    """Print ``msg`` on both streams (a caller that keeps only the end of
    standard error still reads which gate failed) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def normalised(c, Hl: int, Wl: int):
    """Pixel coords (..., 2) of an (Hl, Wl) plane, x wrapped mod Wl, as
    ``F.grid_sample(align_corners=True)`` takes them: with zero padding it
    then blends column Wl - 1 toward zero, as the port's sampler does."""
    import torch
    xn = torch.remainder(c[..., 0], Wl) * (2.0 / (Wl - 1)) - 1
    yn = c[..., 1] * (2.0 / (Hl - 1)) - 1
    return torch.stack([xn, yn], -1)


def grid_sample_library(vA, vB, coords):
    """One level's library yardstick: 4 ``F.grid_sample`` calls at the
    precomputed tap coords (own_A in A, cross_A in B, own_B in B, cross_B
    in A), wrapped and normalised beforehand; None for a 1-pixel extent."""
    import torch.nn.functional as F
    _, BQ, Hl, Wl = vA.shape
    if Hl < 2 or Wl < 2:
        return None
    gs = [normalised(c, Hl, Wl).reshape(BQ, 1, 81, 2) for c in coords]
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
        NTAP, dccl_level_lookup, dccl_level_lookup_coords,
        dccl_level_lookup_plain)

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                   err=0.0, queued_ms=0.0, library_queued_ms=0.0)
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
                # the column body against row 3's one-thread-per-tap body
                # at the coords kernel's coords: the same bits
                row3 = dccl_level_lookup_coords(
                    vA, vB, cA, cB, s, *given_coords(cA, cB, gA, gB, s))
                if not all(torch.equal(a, b) for a, b in zip(got, row3)):
                    fail(f"dccl lookup {tag} level {lvl}: kernel 1 not "
                         f"bitwise equal to row 3 at the coords kernel's "
                         f"coords")
                ms = cuda_ms(lambda: dccl_level_lookup(*args), 50)
                q_ms = queued_ms(lambda: dccl_level_lookup(*args), 50)
                plain_ms = cuda_ms(lambda: dccl_level_lookup_plain(*args), 5,
                                   warmup=2)
                coords = lookup_sample_coords(cA, cB, gA, gB, s)
                BQ, Hl, Wl = vA.shape[1], vA.shape[2], vA.shape[3]
                nbytes, sectors = lookup_bytes(vA, vB, coords,
                                               2 * gA.numel() * 4)
                ops = BQ * NTAP * LOOKUP_OPS_PER_TAP
                b_ms, _ = bound(nbytes, ops, peaks)
                library = grid_sample_library(vA, vB, coords)
                lib_ms = lib_q_ms = None
                if dtype == torch.float32 and library is not None:
                    lib_ms = cuda_ms(library, 50)
                    lib_q_ms = queued_ms(library, 50)
            print(f"  dccl {tag} level {lvl} ({BQ}x{Hl}x{Wl}): err {err:.3e} "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms  "
                  f"bound {b_ms:.4f} ms ({sectors} sectors, {nbytes / 1e6:.2f} MB); "
                  f"card's own time (launches queued): kernel {q_ms:.4f} ms, "
                  f"library {lib_q_ms if lib_q_ms is None else round(lib_q_ms, 4)} "
                  f"ms", flush=True)
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["bytes"] += nbytes
            tot["ops"] += ops
            tot["library_ms"] += lib_ms or 0.0
            tot["queued_ms"] += q_ms
            tot["library_queued_ms"] += lib_q_ms or 0.0
            tot["err"] = max(tot["err"], err)
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"], peaks)
        tot["call_ms"], tot["call_queued_ms"] = dccl_call_ms(dtype, dev, grids)
        rows[tag] = tot
        print(f"  dccl {tag} one iteration (4 levels): kernel {tot['ms']:.4f} ms "
              f"plain {tot['plain_ms']:.4f} ms bound {tot['bound_ms']:.4f} ms; "
              f"queued: kernel {tot['queued_ms']:.4f} ms, library "
              f"{tot['library_queued_ms']:.4f} ms; the grid-route DCCLFused "
              f"call: {tot['call_ms']:.4f} ms, queued "
              f"{tot['call_queued_ms']:.4f} ms", flush=True)
        if dtype == torch.float32:
            verdict = ("no slower than" if tot["ms"] <= tot["library_ms"]
                       else "slower than")
            print(f"  kernel 1 issued back to back is {verdict} its 16 "
                  f"F.grid_sample ({tot['ms']:.4f} against "
                  f"{tot['library_ms']:.4f} ms)", flush=True)

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


def dccl_call_ms(dtype, dev, grids):
    """One grid-route ``DCCLFused`` call, as the forward makes it every
    iteration (four levels into the (1, Q, 4*81) fields, the cross fields
    rotated back), at 512x1024, batch 1: ms issued back to back and
    queued."""
    import torch
    from prior_flow_tpu_torch.ops.corr import DCCLFused
    ins = [lookup_inputs(lvl, dtype, dev, grids) for lvl in range(LEVELS)]
    cA, cB = (c.reshape(1, H // 8, W // 8, 2) for c in ins[0][2:4])
    args = (cA, cB, [i[0] for i in ins], [i[1] for i in ins],
            grids.a2b_w2c_8, grids.b2a_w2c_8, grids.a2b_8, grids.b2a_8)
    dccl = DCCLFused(LEVELS, fuse_levels=False)
    with torch.no_grad():
        # a call launches some 120 kernels (the two back-rotations are
        # plain PyTorch): 4 calls fit the card's queue
        return (cuda_ms(lambda: dccl(*args), 50),
                queued_ms(lambda: dccl(*args), 4))


# -- phase 3: instance-norm sums -----------------------------------------------

def sums_check(x, what: str) -> float:
    """The sums kernel on x against its plain version within
    SUMS_RTOL / SUMS_ATOL; the max abs error."""
    from prior_flow_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_sums, instance_norm_sums_plain)
    got = instance_norm_sums(x, x)
    ref = instance_norm_sums_plain(x, x)
    err = 0.0
    for a, b in zip(got, ref):
        over = (a - b).abs() - (SUMS_ATOL + SUMS_RTOL * b.abs())
        if over.max().item() > 0:
            fail(f"instance-norm sums {what}: beyond rtol/atol {SUMS_RTOL}")
        err = max(err, (a - b).abs().max().item())
    return err


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
                err = sums_check(x, f"{tag} {shape}")
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


# -- phase 5: precision ----------------------------------------------------------

def phase_precision(dev, ref, c1, c2):
    """build_model() at torch's default backend flags (TF32 on for cuDNN
    convolutions, off for matmuls) and build_model(precision="highest")
    under the same flags, each on the card against the CPU's 128x256
    forward ``ref``: the default's error is reported, the highest one's
    gated at CARD_CPU_TOL x flow scale, and the forward must leave the
    flags as it found them. The script's TF32-off setting is put back
    after."""
    import torch
    from prior_flow_tpu_torch import build_model
    scale = ref.abs().max().item()
    ratios = {}
    torch.backends.cudnn.allow_tf32 = True      # torch's default
    try:
        for precision in (None, "highest"):
            out = build_model(seed=0, precision=precision)(
                c1.to(dev), c2.to(dev), iters=4).cpu()
            if not (torch.backends.cudnn.allow_tf32
                    and not torch.backends.cuda.matmul.allow_tf32):
                fail(f"precision={precision!r}: the forward left torch's "
                     f"TF32 flags changed")
            if not torch.isfinite(out).all():
                fail(f"precision={precision!r}: non-finite output")
            err = (out - ref).abs().max().item()
            ratios[str(precision)] = err / scale
            print(f"  build_model(precision={precision!r}) at torch's default "
                  f"flags (TF32 on for convolutions): max abs err {err:.3e} "
                  f"against the CPU, ratio {err / scale:.3e} (gate "
                  f"{CARD_CPU_TOL}{'' if precision else ', reported only'})",
                  flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    if ratios["highest"] > CARD_CPU_TOL:
        fail("precision='highest' on the card and the CPU disagree")
    return ratios


# -- phase 6: cross tap coords --------------------------------------------------

def train_centres(dev, N: int, seed: int, size=None):
    """N unscaled 1/8 centres of an (H, W) input (``size``, default the
    512x1024 main path) over the image and a margin, with the seam, a hair
    below 0 and the pole rows pinned (as in lookup_inputs)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    h8, w8 = (size or (H, W))[0] // 8, (size or (H, W))[1] // 8
    u = torch.rand(2, N, generator=g, device=dev)
    c = torch.stack([u[0] * (w8 + 4) - 2, u[1] * (h8 + 4) - 2], dim=-1)
    c[:6] = torch.tensor([[w8 - 1, 0.0], [w8 - 0.5, h8 - 1], [-1e-8, 5.0],
                          [-0.5, -0.5], [w8 - 1e-3, h8 - 0.5],
                          [0.0, h8 - 1.0]], device=dev)
    return c.contiguous()


def phase_coords(dev, grids, grids2, peaks):
    """The coords kernel where the main paths launch it: the planes route
    of the 1024x2048 forward, one launch per iteration for both branches
    and all four levels (``dccl_cross_coords`` from ``DCCLFused``, the
    level scale applied inside), bitwise against its plain version; ms per
    forward (12 launches) issued back to back and queued, beside its bound,
    the plain version and F.grid_sample. Then the same call at the 512x1024
    level shapes, batch 1 and the training batch: bitwise its plain
    version, kernel 1's cross taps bitwise the plain sampler of the other
    volume at these coords, and the one-branch entry bitwise these
    coords."""
    import torch
    import torch.nn.functional as F
    from prior_flow_tpu_torch.ops.kernels.dccl_coords import (
        dccl_cross_coords, dccl_cross_coords_plain, dccl_grid_coords)
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        NTAP, dccl_level_lookup, sample_volume_level, window_delta)

    def bitwise(got, ref, what):
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            fail(f"coords {what}: not bitwise equal (max abs err {err})")

    scales = [1.0 / 2 ** lvl for lvl in range(LEVELS)]
    Hg, Wg = H2 // 8, W2 // 8
    Q = Hg * Wg
    gA, gB = grids2.a2b_w2c_8, grids2.b2a_w2c_8
    cA, cB = (train_centres(dev, Q, seed, (H2, W2)).reshape(1, Q, 2)
              for seed in (7, 8))
    call = lambda: dccl_cross_coords(cA, cB, gA, gB, scales)
    with torch.no_grad():
        bitwise(call(), dccl_cross_coords_plain(cA, cB, gA, gB, scales),
                f"{H2}x{W2}, both branches, {LEVELS} levels, against the "
                f"plain version")
        # per forward: one launch per iteration
        ms = ITERS * cuda_ms(call, 20)
        q_ms = ITERS * queued_ms(call, 20)
        plain_ms = ITERS * cuda_ms(lambda: dccl_cross_coords_plain(
            cA, cB, gA, gB, scales), 2, warmup=1)
        # library: F.grid_sample of each grid at its window coords, wrapped
        # and normalised beforehand
        libs = []
        for cen, grid in ((cA, gA), (cB, gB)):
            win = (torch.cat([cen.reshape(-1, 2) * sc for sc in scales])
                   .unsqueeze(1) + window_delta(4, dev))
            libs.append((grid.permute(2, 0, 1).unsqueeze(0).contiguous(),
                         normalised(win, Hg, Wg).reshape(1, -1, NTAP, 2)))
            del win
        library = lambda: [F.grid_sample(img, gn, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True)
                           for img, gn in libs]
        lib_ms = ITERS * cuda_ms(library, 20)
        lib_q_ms = ITERS * queued_ms(library, 20)
        del libs
    N = LEVELS * Q
    nbytes = ITERS * (2 * Q * 8 + 2 * gA.numel() * 4 + 4 * N * NTAP * 4)
    ops = ITERS * 2 * N * NTAP * COORDS_OPS_PER_TAP
    tot = dict(ms=ms, queued_ms=q_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_queued_ms=lib_q_ms, bytes=nbytes, ops=ops, err=0.0)
    tot["bound_ms"], tot["bound_by"] = bound(nbytes, ops, peaks)
    print(f"  coords {H2}x{W2}, both branches, {LEVELS} levels x {Q} "
          f"centres: bitwise equal; per forward ({ITERS} launches): kernel "
          f"{ms:.4f} ms, queued {q_ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"2 F.grid_sample {lib_ms:.4f} ms, queued {lib_q_ms:.4f} ms; bound "
          f"{tot['bound_ms']:.4f} ms ({tot['bound_by']})", flush=True)
    verdict = ("no slower than" if ms <= lib_ms else "slower than")
    print(f"  the coords kernel issued back to back is {verdict} its "
          f"F.grid_sample ({ms:.4f} against {lib_ms:.4f} ms per forward)",
          flush=True)

    # the 512x1024 level shapes, batch 1 and the training batch
    Q1 = (H // 8) * (W // 8)
    g1A, g1B = grids.a2b_w2c_8, grids.b2a_w2c_8
    for b in (1, TRAIN_B):
        cA, cB = (train_centres(dev, b * Q1, seed + b).reshape(b, Q1, 2)
                  for seed in (9, 19))
        g = torch.Generator(device=dev).manual_seed(500 + b)
        with torch.no_grad():
            planes = dccl_cross_coords(cA, cB, g1A, g1B, scales)
            bitwise(planes, dccl_cross_coords_plain(cA, cB, g1A, g1B, scales),
                    f"{H}x{W} batch {b} against the plain version")
            for lvl, sc in enumerate(scales):
                rows = slice(lvl * b * Q1, (lvl + 1) * b * Q1)
                level = [p[rows] for p in planes]
                bitwise(dccl_grid_coords(cA.reshape(-1, 2), g1A, sc)
                        + dccl_grid_coords(cB.reshape(-1, 2), g1B, sc),
                        level, f"{H}x{W} batch {b} level {lvl}: the one-branch "
                        f"entry against the both-branch one")
                Hl, Wl = (H // 8) >> lvl, (W // 8) >> lvl
                vA, vB = (torch.randn(b, Q1, Hl, Wl, generator=g, device=dev)
                          for _ in range(2))
                _, cross_A, _, cross_B = dccl_level_lookup(vA, vB, cA, cB, g1A,
                                                           g1B, sc)
                for cross, other, x, y in ((cross_A, vB, *level[:2]),
                                           (cross_B, vA, *level[2:])):
                    at = torch.stack([x, y], -1).reshape(b, Q1, NTAP, 2)
                    if not torch.equal(cross, sample_volume_level(other, at)):
                        fail(f"lookup {H}x{W} batch {b} level {lvl}: cross "
                             f"taps differ from the plain sampler at the "
                             f"coords kernel's coords")
                del vA, vB, cross_A, cross_B
        del planes
        torch.cuda.empty_cache()
    print(f"  coords {H}x{W}, batch 1 and {TRAIN_B}, both branches, all "
          f"levels: bitwise equal to the plain version and to the one-branch "
          f"entry; kernel 1's cross taps == plain sampler at these coords",
          flush=True)
    return tot


# -- phase 7: volume scatter -----------------------------------------------------

def scatter_inputs(dev, lvl: int, S: int, grids):
    """Tap cotangents, own centres, the other branch's centres and its
    cross coords (from the coords kernel) at the training shape of one
    level."""
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
            other.reshape(S, TRAIN_B, Q, 2), cx.reshape(shape),
            cy.reshape(shape))


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
    """Both scatter entries against their plain versions at the training
    level shapes (B = 4), S = 1 and 12, f32 and bf16 output; the grid entry
    also against the given-coords entry fed the coords kernel's coords.
    Times: one taped step (8 launches, S = 12) and one standard step (96
    launches, S = 1) of each entry, bf16 output."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_scatter import (
        dccl_level_scatter, dccl_level_scatter_grid,
        dccl_level_scatter_grid_plain, dccl_level_scatter_plain)

    Q = (H // 8) * (W // 8)
    BQ = TRAIN_B * Q
    grid = grids.b2a_w2c_8
    rows = {e: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                    err=0.0, standard_step_ms=0.0, standard_bytes=0.0,
                    standard_ops=0.0) for e in ("grid", "given")}
    for lvl in range(LEVELS):
        Hl, Wl = (H // 8) >> lvl, (W // 8) >> lvl
        s = 1.0 / 2 ** lvl
        full = scatter_inputs(dev, lvl, ITERS, grids)
        for S in (1, ITERS):
            g_own, cen, g_cross, other, cx, cy = (t[:S].contiguous()
                                                  for t in full)
            calls = {
                "grid": (lambda d: dccl_level_scatter_grid(
                    g_own, cen, g_cross, other, grid, s, Hl, Wl, d),
                    lambda d: dccl_level_scatter_grid_plain(
                        g_own, cen, g_cross, other, grid, s, Hl, Wl, d)),
                "given": (lambda d: dccl_level_scatter(
                    g_own, cen, s, g_cross, cx, cy, Hl, Wl, d),
                    lambda d: dccl_level_scatter_plain(
                        g_own, cen, s, g_cross, cx, cy, Hl, Wl, d))}
            for dtype in (torch.float32, torch.bfloat16):
                with torch.no_grad():
                    got = {e: k(dtype) for e, (k, _) in calls.items()}
                    ref = {e: p(dtype) for e, (_, p) in calls.items()}
                    torch.cuda.synchronize()
                for key, a, b in (("grid", got["grid"], ref["grid"]),
                                  ("given", got["given"], ref["given"]),
                                  ("grid vs given", got["grid"],
                                   got["given"])):
                    a, b = a.float(), b.float()
                    top = b.abs().max().item()
                    over = (a - b).abs() - (SCATTER_RTOL * top + 1e-6)
                    if dtype == torch.bfloat16:   # one bf16 step apart
                        over = over - 2.0 ** -7 * b.abs()
                    err = (a - b).abs().max().item()
                    if over.max().item() > 0:
                        fail(f"scatter {key} level {lvl} S={S} {dtype}: "
                             f"beyond tolerance (max abs err {err:.3e}, "
                             f"max|ref| {top:.3e})")
                    if dtype == torch.float32 and key in rows:
                        rows[key]["err"] = max(rows[key]["err"], err)
                del got, ref
            with torch.no_grad():
                ms = {e: cuda_ms(lambda: k(torch.bfloat16), 10, warmup=2)
                      for e, (k, _) in calls.items()}
            taps = S * BQ * 81
            dv_bytes = BQ * Hl * Wl * 2
            nbytes = {"grid": 2 * taps * 4 + 2 * S * BQ * 8
                      + grid.numel() * 4 + dv_bytes,
                      "given": 4 * taps * 4 + S * BQ * 8 + dv_bytes}
            ops = {"grid": taps * SCATTER_GRID_OPS_PER_TAP,
                   "given": taps * SCATTER_OPS_PER_TAP}
            if S == 1:
                # one standard step scatters both volumes of every level in
                # each of its ITERS iterations
                for e in rows:
                    rows[e]["standard_step_ms"] += 2 * ITERS * ms[e]
                    rows[e]["standard_bytes"] += 2 * ITERS * nbytes[e]
                    rows[e]["standard_ops"] += 2 * ITERS * ops[e]
                print(f"  scatter level {lvl} ({TRAIN_B}x{Q}x{Hl}x{Wl}) S=1 "
                      f"bf16: grid entry {ms['grid']:.4f} ms, given-coords "
                      f"entry {ms['given']:.4f} ms", flush=True)
                continue
            with torch.no_grad():
                plain_ms = {e: cuda_ms(lambda: p(torch.bfloat16), 2, warmup=1)
                            for e, (_, p) in calls.items()}
                idx, val = scatter_corners(g_own, cen, s, g_cross, cx, cy, Hl,
                                           Wl)
                out = torch.zeros(BQ * Hl * Wl, device=dev)
                lib_ms = cuda_ms(lambda: out.index_put_((idx,), val,
                                                        accumulate=True),
                                 5, warmup=1)
                del idx, val, out
            for e in rows:
                b_ms, _ = bound(nbytes[e], ops[e], peaks)
                print(f"  scatter {e} entry level {lvl} "
                      f"({TRAIN_B}x{Q}x{Hl}x{Wl}) S={S} bf16: kernel "
                      f"{ms[e]:.4f} ms  plain {plain_ms[e]:.4f} ms  "
                      f"index_put_ {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
                      f"({nbytes[e] / 1e9:.3f} GB)", flush=True)
                # one taped step scatters both volumes of every level once
                for k, v in (("ms", ms[e]), ("plain_ms", plain_ms[e]),
                             ("library_ms", lib_ms), ("bytes", nbytes[e]),
                             ("ops", ops[e])):
                    rows[e][k] += 2 * v
        del full
        torch.cuda.empty_cache()
    for e, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], peaks)
        r["standard_bound_ms"], _ = bound(r["standard_bytes"],
                                          r["standard_ops"], peaks)
        print(f"  scatter {e} entry, one taped step (8 launches, S={ITERS}): "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms; one standard step (96 launches, "
              f"S=1): {r['standard_step_ms']:.4f} ms, bound "
              f"{r['standard_bound_ms']:.4f} ms", flush=True)
    return rows


# -- phase 8: instance-norm sums of the backward ---------------------------------

def phase_sums_backward(dev, peaks):
    """The sums of a batch-4 step: 15 forward (x, x) in bf16 and 15
    backward (xhat, dy) in f32, at B = 4 x 4 views."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_sums, instance_norm_sums_plain)

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
               err=0.0, queued_ms=0.0)
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
            q_ms = (queued_ms(lambda: instance_norm_sums(x, x), 20)
                    + queued_ms(lambda: instance_norm_sums(xhat, dy), 20))
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
        print(f"  sums {shape}: forward + backward kernel {ms:.4f} ms "
              f"(queued {q_ms:.4f})  plain {plain_ms:.4f} ms  var_mean + "
              f"vecdot {lib_ms:.4f} ms  bound {b_ms:.4f} ms", flush=True)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bytes", nbytes), ("ops", ops), ("queued_ms", q_ms)):
            tot[k] += NORMS_PER_SHAPE * v
        del xf, x, xhat, dy, fx, fy
    tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"], peaks)
    print(f"  sums one train step (30 launches): kernel {tot['ms']:.4f} ms "
          f"(queued {tot['queued_ms']:.4f}) plain {tot['plain_ms']:.4f} ms "
          f"bound {tot['bound_ms']:.4f} ms", flush=True)
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


def make_trainer(dev, mode: str, mixed: bool, iters: int, seed: int = 0,
                 **model_kw):
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.train import make_optimizer, make_train_step
    model = build_model(dev, seed=seed, mixed_precision=mixed, **model_kw)
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
                              instance_norm_sums=30,
                              dccl_level_scatter_grid=per)
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
    """One step on the card and on the CPU at 128x256, batch 1, 2
    iterations, f32, same weights: both grad modes on the default routes,
    and a standard step with the planes route forced on the card (its
    backward the scatter's given-coords entry) against the CPU's default
    route. Returns the worst gradient difference of each and the forced
    step's launch counts."""
    import torch
    from prior_flow_tpu_torch.ops.corr import DCCLFused
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    worst, planes_counts = {}, None
    for mode in ("standard", "taped", "planes"):
        res = {}
        for d in (torch.device("cpu"), dev):
            model, step = make_trainer(d, "taped" if mode == "taped"
                                       else "standard", False, 2, seed=3)
            if mode == "planes" and d.type == "cuda":
                model.dccl = DCCLFused(grid_in_kernel=False)
            reset_launch_counts()
            m = step(train_batch(5, 1, 128, 256, d), 0)
            if d.type == "cuda":
                torch.cuda.synchronize()
                counts = launch_counts()
            res[d.type] = (float(m["train/loss"]),
                           {n: p.grad.detach().cpu() for n, p in
                            model.named_parameters()})
        if mode == "planes":
            planes_counts = counts
            want = forward_counts(instance_norm_sums=30,
                                  dccl_level_lookup_coords=2 * LEVELS,
                                  dccl_cross_coords=2,
                                  dccl_level_scatter=2 * 2 * LEVELS)
            if counts != want:
                fail(f"train planes route: launch counts {counts}, expected "
                     f"{want}")
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
    return worst, planes_counts


# -- phase 11: the lookup at given cross coords, 1024x2048 ----------------------

def given_coords(cA, cB, gA, gB, scale):
    """The planes route's cross tap coords of both branches at one level
    (the coords kernel's both-branch entry), as four (B, Q, 81) planes."""
    from prior_flow_tpu_torch.ops.kernels.dccl_coords import (
        dccl_cross_coords)
    B, Q, _ = cA.shape
    return [c.reshape(B, Q, 81)
            for c in dccl_cross_coords(cA, cB, gA, gB, [scale])]


def phase_lookup_coords(dev, grids2, peaks):
    """Row 3 against its plain version and against kernel 1, bitwise, at the
    four level shapes of a 1024x2048 forward (B x Q = 32768), f32 and bf16;
    one bf16 level-0 launch at batch 3 (more than 2^31 volume elements).
    Times per iteration (4 levels), issued back to back and queued: row 3,
    kernel 1 (the grid route at these shapes) and the planes route's coords
    launch; and the plain version and 4 F.grid_sample per level."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.dccl_coords import (
        dccl_cross_coords)
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        NTAP, dccl_level_lookup, dccl_level_lookup_coords,
        dccl_level_lookup_coords_plain)

    rows = {}
    scales = [1.0 / 2 ** lvl for lvl in range(LEVELS)]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                   err=0.0, grid_route_ms=0.0, queued_ms=0.0,
                   grid_route_queued_ms=0.0)
        for lvl, s in enumerate(scales):
            vA, vB, cA, cB, gA, gB = lookup_inputs(lvl, dtype, dev, grids2,
                                                   size=(H2, W2))
            with torch.no_grad():
                given = given_coords(cA, cB, gA, gB, s)
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
                row3_call = lambda: dccl_level_lookup_coords(*args)
                k1_call = lambda: dccl_level_lookup(vA, vB, cA, cB, gA, gB, s)
                ms, q_ms = cuda_ms(row3_call, 20), queued_ms(row3_call, 20)
                k1_ms, k1_q_ms = (cuda_ms(k1_call, 20),
                                  queued_ms(k1_call, 20))
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
                  f"plain and to kernel 1; kernel {ms:.4f} ms (queued "
                  f"{q_ms:.4f})  kernel 1 {k1_ms:.4f} ms (queued "
                  f"{k1_q_ms:.4f})  plain {plain_ms:.4f} ms  library "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({sectors} sectors, "
                  f"{nbytes / 1e6:.2f} MB)", flush=True)
            for k, v in (("ms", ms), ("grid_route_ms", k1_ms),
                         ("queued_ms", q_ms),
                         ("grid_route_queued_ms", k1_q_ms),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bytes", nbytes), ("ops", ops)):
                tot[k] += v
            del vA, vB, args, got, ref, k1, coords, library
            torch.cuda.empty_cache()
        # the planes route's coords: one launch, both branches, all levels
        cA, cB = lookup_inputs(0, torch.float32, dev, grids2,
                               size=(H2, W2))[2:4]
        call = lambda: dccl_cross_coords(
            cA, cB, grids2.a2b_w2c_8, grids2.b2a_w2c_8, scales)
        with torch.no_grad():
            tot["coords_ms"] = cuda_ms(call, 20)
            tot["coords_queued_ms"] = queued_ms(call, 20)
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["ops"],
                                                 peaks)
        rows[tag] = tot
        print(f"  {tag} one 1024x2048 iteration: planes route {tot['ms']:.4f} "
              f"(4 lookups) + {tot['coords_ms']:.4f} (1 coords launch) = "
              f"{tot['ms'] + tot['coords_ms']:.4f} ms, queued "
              f"{tot['queued_ms']:.4f} + {tot['coords_queued_ms']:.4f} = "
              f"{tot['queued_ms'] + tot['coords_queued_ms']:.4f} ms; grid "
              f"route (kernel 1, 4 launches) {tot['grid_route_ms']:.4f} ms, "
              f"queued {tot['grid_route_queued_ms']:.4f} ms; bound "
              f"{tot['bound_ms']:.4f} ms", flush=True)

    # 64-bit offsets: a bf16 level-0 batch of 3 x 32768 queries has
    # 3.2e9 > 2^31 elements per volume
    vA, vB, cA, cB, gA, gB = lookup_inputs(0, torch.bfloat16, dev, grids2,
                                           BIG_B, size=(H2, W2))
    with torch.no_grad():
        given = given_coords(cA, cB, gA, gB, 1.0)
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
                q_ms = queued_ms(lambda: dccl_lookup_all_levels(*args), 20)
                per_q_ms = queued_ms(per_level, 20)
                if b == 1 and dtype == torch.float32:
                    row["ms"], row["per_level_ms"] = ms, per_ms
                    row["queued_ms"], row["per_level_queued_ms"] = (q_ms,
                                                                    per_q_ms)
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
                  f"{per_ms:.4f} ms; queued {q_ms:.4f} ms against "
                  f"{per_q_ms:.4f} ms", flush=True)
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
    48 lookups at given coords, 12 coords launches, no kernel 1; then the
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
                          dccl_cross_coords=ITERS)
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
                            dccl_cross_coords=4)
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


# -- phase 15: primitive-rate anchors ----------------------------------------------

# integer operations per edge step of the gather plan's Euler splits (the
# candidate tests and the walk), counted at the f32 rate
PLAN_OPS_PER_EDGE_STEP = 24


def phase_anchors(dev, peaks, sms: int, clock_hz: float):
    """The anchor tool's run (gates, SASS counts, measurement) at its size,
    beside each kernel's bound; returns the chains', the plan's and the
    copy's rows and the tool run's launch counts."""
    import torch
    from prior_flow_tpu_torch.tools import microbench_vpu_anchor as va

    try:
        chains, step, plan, launches = va.run(dev)
    except va.GateError as e:
        fail(str(e))
    rows = va.GRID * va.TILE_R
    row_bytes = va.LANES * 4
    plan_bytes = rows * va.LANES * 2
    # x and idx read, the output written; the gather also reads its plan
    t_bytes = {kind: (3 * rows * row_bytes
                      + (plan_bytes if kind == "gather" else 0))
               / peaks[0] * 1e3 for kind in va.KINDS}
    chain = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
                 bound_by="operations", err=0.0, per={})
    for (kind, ilp), c in chains.items():
        t_ops = va.ops_bound_ms(kind, va.N_ELEM, sms, clock_hz)
        print(f"  anchor {va.chain_line(kind, ilp, c, sms, clock_hz).strip()}"
              f"; bytes bound {t_bytes[kind]:.4f} ms", flush=True)
        chain["ms"] += c["ms"]
        chain["plain_ms"] += c["plain_ms"]
        chain["bound_ms"] += max(t_ops, t_bytes[kind])
        chain["err"] = max(chain["err"], c["err"])
        chain["per"][f"{kind}_ilp{ilp}"] = round(c["ms"], 4)
    # idx read, the plan written; two splits of 128 edge steps per row
    plan_row = dict(plan, library_ms=None, err=0.0)
    plan_row["bound_ms"], plan_row["bound_by"] = bound(
        rows * row_bytes + plan_bytes,
        rows * 2 * va.LANES * PLAN_OPS_PER_EDGE_STEP, peaks)
    print(f"  {va.plan_line(plan)}; bound {plan_row['bound_ms']:.4f} ms "
          f"({plan_row['bound_by']})", flush=True)
    t0, t1 = va.STEP_TILES
    copy = dict(step, ms=step["ms"][t1], small_ms=step["ms"][t0], err=0.0,
                library_ms=va.cold_ms(lambda x: torch.mul(x, 2.0), dev, t1))
    n = t1 * va.TILE_ROWS * va.LANES
    copy["bound_ms"], copy["bound_by"] = bound(2 * n * 4, n, peaks)
    print(f"  {va.step_line(step)}; {t1} blocks: torch.mul "
          f"{copy['library_ms']:.4f} ms, bound {copy['bound_ms']:.4f} ms",
          flush=True)
    print(f"  anchors, six chains: {chain['ms']:.4f} ms against a bound of "
          f"{chain['bound_ms']:.4f} ms ({sms} SMs at "
          f"{clock_hz / 1e9:.3f} GHz)", flush=True)
    return chain, plan_row, copy, launches


# -- phase 16: the DCCL stage split ------------------------------------------------

# f32 operations per (query, tap) of each stage, both branches, counted as
# LOOKUP_OPS_PER_TAP is (own 35, grid window 47, cross sample 35, window 4)
STAGE_OPS_PER_TAP = {"own_only": 2 * (35 + 4), "gridwin_only": 2 * (47 + 4),
                     "cross_only": 2 * (47 + 35 + 4)}


def stage_bytes(vA, vB, coords, planes):
    """Bytes each launch of phase 16 must move at one level: the touched
    sectors of the volumes it samples, its outputs, centres, grids (64x128
    f32 x2) and given coords."""
    import torch
    own_A, cross_A, own_B, cross_B = coords
    BQ = vA.shape[1]
    out = BQ * 81 * 4
    cen = 2 * BQ * 8
    grids = 2 * (H // 8) * (W // 8) * 2 * 4
    at = lambda x, y: torch.stack([x, y], -1)
    return {
        "grid_full": lookup_bytes(vA, vB, coords, grids)[0],
        "planes": (touched_sectors(vA, [own_A, at(planes[2], planes[3])])
                   + touched_sectors(vB, [own_B, at(planes[0], planes[1])])
                   ) * 32 + 4 * out + cen + 4 * out,
        "own_only": (touched_sectors(vA, [own_A])
                     + touched_sectors(vB, [own_B])) * 32 + 2 * out + cen,
        "gridwin_only": cen + 4 * out + grids,
        "cross_only": (touched_sectors(vB, [cross_A])
                       + touched_sectors(vA, [cross_B])) * 32 + 2 * out
        + cen + grids}


def stage_libraries(vA, vB, gA, gB, coords):
    """One level's library yardsticks of two stages, each one
    ``F.grid_sample`` with the two branches stacked on the batch, at the
    precomputed normalised window coords (own_A, own_B of ``coords``): the
    volumes for the own taps, the rotation grids for the grid window. The
    cross taps have none: their second sampling reads the first's
    output. The own taps have none for a 1-pixel extent."""
    import torch
    import torch.nn.functional as F
    _, BQ, Hl, Wl = vA.shape
    Hg, Wg, _ = gA.shape
    sample = lambda img, at: F.grid_sample(img, at, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True)
    grids = torch.stack([gA, gB]).permute(0, 3, 1, 2).contiguous()
    win = normalised(torch.cat([coords[0], coords[2]]), Hg, Wg)
    libs = {"gridwin_only": lambda: sample(grids, win)}
    if Hl > 1 and Wl > 1:
        vols = torch.cat([vA, vB], 1).reshape(2 * BQ, 1, Hl, Wl)
        own = normalised(torch.cat([coords[0], coords[2]], 1), Hl,
                         Wl).reshape(2 * BQ, 1, 81, 2)
        libs["own_only"] = lambda: sample(vols, own)
    return libs


def phase_stage_split(dev, peaks):
    """The kernel-split tool's run at 512x1024, batch 1, four levels, f32
    and bf16 (gates, then measurement), beside each launch's bound, the
    plain versions and the library calls. Returns the three stage rows
    (f32, four levels summed) and the tool run's launch counts."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import WRAPPERS
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import NTAP
    from prior_flow_tpu_torch.ops.kernels.dccl_stages import PLAIN
    from prior_flow_tpu_torch.tools import microbench_kernel_split as ks

    ops_per_tap = dict(STAGE_OPS_PER_TAP, grid_full=LOOKUP_OPS_PER_TAP,
                       planes=LOOKUP_COORDS_OPS_PER_TAP)
    rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=None, bytes=0.0,
                       ops=0.0, err=0.0) for name in ks.STAGES}
    launches = dict.fromkeys(WRAPPERS, 0)
    try:
        for run in ks.run(dev):
            tag, lvl, rec, s = run["dtype"], run["level"], run["rec"], \
                run["scale"]
            for k, v in run["launches"].items():
                launches[k] += v
            vA, vB, cA, cB, gA, gB = ins = run["ins"]
            BQ = vA.shape[1]
            with torch.no_grad():
                coords = lookup_sample_coords(cA, cB, gA, gB, s)
                nbytes = stage_bytes(vA, vB, coords, run["planes"])
                libs = stage_libraries(vA, vB, gA, gB, coords)
            parts = []
            for name in ("grid_full", "planes") + tuple(ks.STAGES):
                ops = BQ * NTAP * ops_per_tap[name]
                b_ms, _ = bound(nbytes[name], ops, peaks)
                parts.append(f"{name} {rec[name + '_ms']:.4f} (bound "
                             f"{b_ms:.4f})")
                if name not in ks.STAGES:
                    continue
                r = rows[name]
                r["err"] = max(r["err"], run["errs"][name])
                if tag != "f32":
                    continue
                r["ms"] += rec[name + "_ms"]
                r["bytes"] += nbytes[name]
                r["ops"] += ops
                with torch.no_grad():
                    r["plain_ms"] += cuda_ms(lambda: PLAIN[
                        name.split("_")[0]](*ins, s), 1, warmup=1)
                    if name in libs:
                        lib = queued_ms(libs[name], 50)
                        r["library_ms"] = (r["library_ms"] or 0.0) + lib
                        parts[-1] += f" [F.grid_sample {lib:.4f}]"
            print(f"  stage split {tag} level {lvl} ({BQ}x{vA.shape[2]}x"
                  f"{vA.shape[3]}): own and cross bitwise kernel 1's, grid "
                  f"window bitwise the coords kernel's; plain errors "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in run['errs'].items())}"
                  f"; card ms (queued): " + "; ".join(parts)
                  + f"; kernel 1 issued back to back "
                  f"{rec['grid_full_paced_ms']:.4f}", flush=True)
            del run, ins, vA, vB, coords, libs
            torch.cuda.empty_cache()
    except ks.GateError as e:
        fail(f"stage split {e}")
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], r["ops"], peaks)
    print("  stage split f32, four levels (card ms, queued): " + "; ".join(
        f"{k} {r['ms']:.4f} ms (plain {r['plain_ms']:.2f}, library "
        f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
        f", bound {r['bound_ms']:.4f})" for k, r in rows.items()), flush=True)
    return rows, launches


# -- phase 17: grid-window variants ------------------------------------------------

def phase_gridwin(dev, peaks):
    """The gridwin tool's run at its shapes (gates, then measurement),
    the plain versions and F.grid_sample. Returns the variant and pair
    rows, the row of two one-branch coords launches, and the tool run's
    launch counts."""
    import torch
    import torch.nn.functional as F
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (NTAP,
                                                              window_delta)
    from prior_flow_tpu_torch.ops.kernels.gridwin_variants import (
        gridwin_pair_plain, gridwin_variant_plain)
    from prior_flow_tpu_torch.tools import microbench_gridwin as gw

    try:
        (cen, cenB, gA, gB), rec, launches = gw.run(dev)
    except gw.GateError as e:
        fail(str(e))
    N = cen.shape[0]
    Hg, Wg, _ = gA.shape
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: gridwin_variant_plain(cen, gA, gB, gw.SCALE),
                           3, warmup=1)
        pair_plain_ms = cuda_ms(lambda: gridwin_pair_plain(cen, cenB, gA, gB,
                                                           gw.SCALE), 3,
                                warmup=1)
        # library: F.grid_sample of each grid at the normalised window coords
        libs = [normalised((c * gw.SCALE).unsqueeze(1) + window_delta(4, dev),
                           Hg, Wg).unsqueeze(0) for c in (cen, cenB)]
        imgs = [g.permute(2, 0, 1).unsqueeze(0).contiguous() for g in (gA, gB)]

        def library(second):
            for img in imgs:
                F.grid_sample(img, libs[second], mode="bilinear",
                              padding_mode="zeros", align_corners=True)
        lib_ms = queued_ms(lambda: library(0), 50)
        pair_lib_ms = queued_ms(lambda: [F.grid_sample(
            img, g, mode="bilinear", padding_mode="zeros", align_corners=True)
            for img, g in zip(imgs, libs)], 50)
    out_bytes = 4 * N * NTAP * 4
    grid_bytes = 2 * gA.numel() * 4
    variant = dict(ms=rec["smem_grid_ms"], direct_ms=rec["direct_ms"],
                   plain_ms=plain_ms, library_ms=lib_ms, err=0.0)
    variant["bound_ms"], variant["bound_by"] = bound(
        N * 8 + out_bytes + grid_bytes, 2 * N * NTAP * COORDS_OPS_PER_TAP,
        peaks)
    pair = dict(ms=rec["pair_ms"], plain_ms=pair_plain_ms,
                library_ms=pair_lib_ms, err=0.0)
    pair["bound_ms"], pair["bound_by"] = bound(
        2 * N * 8 + out_bytes + grid_bytes, 2 * N * NTAP * COORDS_OPS_PER_TAP,
        peaks)
    # the same work as two one-branch launches of the coords kernel
    one_branch = dict(pair, ms=rec["coords_kernel_x2_ms"])
    print(f"  gridwin Q={N}, grids {Hg}x{Wg}: direct and smem_grid variants "
          f"and the pair bitwise equal to the coords kernel, the reads and "
          f"arith diagnostics to their plain versions; ms: "
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in rec.items())
          + f"; plain {plain_ms:.4f} (pair {pair_plain_ms:.4f}); 2 "
          f"F.grid_sample {lib_ms:.4f} (pair {pair_lib_ms:.4f}); bound "
          f"{variant['bound_ms']:.4f} (pair {pair['bound_ms']:.4f}, "
          f"{variant['bound_by']})", flush=True)
    variant["per"] = {k: round(v, 4) for k, v in rec.items()}
    return variant, pair, one_branch, launches


# -- phase 18: the evaluation path ---------------------------------------------

EVAL_PAIRS = 3            # frames per scene less one
EVAL_SMALL = (128, 256)   # the card-vs-CPU twin of the tree
EVAL_SMALL_ITERS = 4
EVAL_CARD_CPU_RTOL = CARD_CPU_TOL   # each metric, relative
EVAL_BATCH_RTOL = 1e-5    # batch 2 against batch 1, each metric, relative
ORACLE_EPE, ORACLE_SEPE = 1e-5, 1e-4


def write_mpf_scene(root: str, scene: str, frames: int, h: int, w: int,
                    rng) -> None:
    """``frames`` random PNG frames (``image/*.png``) and ``.flo`` ground
    truth (``flow/*.flo``) of an MPF scene directory, drawn from ``rng``
    and written by the port's own writers."""
    import numpy as np
    from prior_flow_tpu_torch.data import frame_utils
    for sub in ("image", "flow"):
        os.makedirs(os.path.join(root, scene, sub), exist_ok=True)
    for i in range(frames):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        frame_utils.write_image(
            os.path.join(root, scene, "image", f"{i:04d}.png"), img)
        flow = (rng.normal(size=(h, w, 2)) * 4).astype(np.float32)
        frame_utils.write_flo(
            os.path.join(root, scene, "flow", f"{i:04d}.flo"), flow)


def eval_tree(root: str, h: int, w: int, seed: int) -> str:
    """A seeded synthetic MPF test split under ``root``: ``EFTs_Car100``
    and ``City_100_r``, EVAL_PAIRS + 1 frames each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    for scene in ("EFTs_Car100", "City_100_r"):
        write_mpf_scene(root, scene, EVAL_PAIRS + 1, h, w, rng)
    return root


def metric_values(res: dict) -> dict:
    """A validator's result flattened to {name: value}."""
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update({f"{k}-{m}": x for m, x in v.items()})
        else:
            out[k] = v
    return out


def gate_close(tag: str, got: dict, ref: dict, rtol: float) -> float:
    """Fails unless every metric of ``got`` lies within ``rtol`` of
    ``ref`` (relative); returns the largest relative difference."""
    got, ref = metric_values(got), metric_values(ref)
    if got.keys() != ref.keys():
        fail(f"{tag}: metric names {sorted(got)} against {sorted(ref)}")
    worst = 0.0
    for k in ref:
        rel = abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30)
        worst = max(worst, rel)
        if not (math.isfinite(got[k]) and rel <= rtol):
            fail(f"{tag}: {k} = {got[k]!r} against {ref[k]!r} "
                 f"(relative {rel:.3e}, gate {rtol})")
    return worst


def run_counted(fn, want_per_pair: dict, pairs: int, tag: str):
    """``fn()`` with the launch counts set to 0 just before and read just
    after; fails unless every wrapper launched ``pairs`` times its count
    per pair."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: v * pairs for k, v in want_per_pair.items()}
    if counts != want:
        fail(f"{tag}: launch counts {counts}, expected {want}")
    return out, counts


def phase_eval(dev, forward_ms: float):
    """The evaluation path through its CLIs on the card at full width (the
    published PriOr-RAFT, seeded weights from a .pth, 512x1024, a synthetic
    MPF test split): launch counts per pair, finite metrics; the 128x256
    twin on the card against the CPU; batch 2 against batch 1; an oracle
    model; the video CLI with a warm start and demo_image; the loop's ms
    per pair and its host stages."""
    import numpy as np
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.cli import demo_image, evaluate, video
    from prior_flow_tpu_torch.data import datasets, frame_utils, native
    from prior_flow_tpu_torch.eval import evaluate as V

    base = os.path.join(REPO, "build", "phase18")
    t0 = time.perf_counter()
    big = eval_tree(os.path.join(base, f"mpf_{H}x{W}"), H, W, seed=18)
    small = eval_tree(os.path.join(base, "mpf_{}x{}".format(*EVAL_SMALL)),
                      *EVAL_SMALL, seed=19)
    pth = os.path.join(base, "weights.pth")
    torch.save(build_model("cpu", seed=0).state_dict(), pth)
    print(f"  trees {H}x{W} and {EVAL_SMALL[0]}x{EVAL_SMALL[1]} and the "
          f"weights written in {time.perf_counter() - t0:.1f} s", flush=True)

    # the host library, built from the checkout's source into build/
    lib = native.build(os.path.join(base, "native"))
    if native.load(lib) is None or not native.available():
        fail(f"native library {lib} did not load")
    flo = os.path.join(big, "EFTs_Car100", "flow", "0001.flo")
    ref = frame_utils.read_flo(flo)
    ref[:, :, 0] = (ref[:, :, 0] + W / 2) % W - W / 2
    got = native.read_flo(flo, wrap_u=True)
    nerr = float(np.abs(got - ref).max())
    if nerr > 1e-4:
        fail(f"native read_flo with the u-wrap: max abs err {nerr:.3e}")
    print(f"  native library built and loaded; read_flo(wrap_u) within "
          f"{nerr:.2e} of numpy", flush=True)

    args = ["--model", pth, "--data_root", big]
    res, counted = {}, {}
    for tag, extra, iters in (
            ("dense", ["--dataset", "MPFDataset", "--scene", "EFT"], ITERS),
            ("regions", ["--dataset", "MPFDataset", "--scene", "EFT",
                         "--regions"], ITERS),
            ("City100", ["--dataset", "City100"], 2 * ITERS)):
        want = forward_counts(dccl_level_lookup=4 * iters)
        res[tag], counts = counted[tag] = run_counted(
            lambda: evaluate.main(args + extra), want, EVAL_PAIRS,
            f"cli.evaluate {tag}")
        values = metric_values(res[tag])
        if not all(math.isfinite(v) for v in values.values()):
            fail(f"cli.evaluate {tag}: non-finite metrics {values}")
        print(f"  cli.evaluate {tag} {H}x{W} iters {iters}: {values}; "
              f"launches {dict((k, v) for k, v in counts.items() if v)}",
              flush=True)
    eval_counts = {k: v // EVAL_PAIRS for k, v in counted["dense"][1].items()}

    worst = {}
    sargs = ["--model", pth, "--data_root", small, "--iters",
             str(EVAL_SMALL_ITERS), "--dataset", "MPFDataset", "--scene",
             "EFT"]
    for tag, extra in (("dense", []), ("regions", ["--regions"])):
        card = evaluate.main(sargs + extra)
        cpu = evaluate.main(sargs + extra + ["--device", "cpu"])
        worst[tag] = gate_close(f"card vs CPU {tag}", card, cpu,
                                EVAL_CARD_CPU_RTOL)
    print(f"  card vs CPU at {EVAL_SMALL[0]}x{EVAL_SMALL[1]}, "
          f"{EVAL_SMALL_ITERS} iterations: largest relative difference per "
          f"validator {worst} (gate {EVAL_CARD_CPU_RTOL})", flush=True)

    batch2 = evaluate.main(args + ["--dataset", "MPFDataset", "--scene",
                                   "EFT", "--eval_batch_size", "2"])
    bworst = gate_close("batch 2 vs batch 1", batch2, res["dense"],
                        EVAL_BATCH_RTOL)

    val = datasets.MPFDataset(split="test", scene="EFT", root=big)
    gts = [torch.from_numpy(val[i][2]).to(dev) for i in range(len(val))]

    class Oracle(torch.nn.Module):
        """Returns the ground truth of the k-th pair on its k-th call."""

        def __init__(self):
            super().__init__()
            self.register_buffer("anchor", torch.zeros(1, device=dev))
            self.calls = 0

        def forward(self, image1, image2, iters=12):
            self.calls += 1
            return gts[self.calls - 1][None]

    oracle = V.validate_mpf(Oracle(), data_root=big)
    if not (oracle["EFT-epe"] < ORACLE_EPE
            and oracle["EFT-SEPE"] < ORACLE_SEPE):
        fail(f"oracle model: {oracle} (gates EPE {ORACLE_EPE}, SEPE "
             f"{ORACLE_SEPE})")
    print(f"  batch 2 vs batch 1 on {EVAL_PAIRS} pairs: largest relative "
          f"difference {bworst:.3e} (gate {EVAL_BATCH_RTOL}); oracle "
          f"{oracle}", flush=True)

    out_dir = os.path.join(base, "video")
    frames = os.path.join(big, "EFTs_Car100", "image")
    video.main(["--model", pth, "--input", frames, "--output", out_dir,
                "--warm_start"])
    flows = sorted(f for f in os.listdir(out_dir) if f.endswith(".flo"))
    if len(flows) != EVAL_PAIRS:
        fail(f"cli.video wrote {flows}")
    for f in flows:
        fl = frame_utils.read_flo(os.path.join(out_dir, f))
        if fl.shape != (H, W, 2) or not np.isfinite(fl).all():
            fail(f"cli.video: {f} shape {fl.shape} or non-finite")
    png = os.path.join(base, "flow_pr.png")
    demo_image.main(["--model", pth, "--image1",
                     os.path.join(frames, "0001.png"), "--image2",
                     os.path.join(frames, "0000.png"), "--output", png])
    if frame_utils.read_image(png).shape != (H, W, 3):
        fail(f"cli.demo_image: {png} does not read back as ({H}, {W}, 3)")
    print(f"  cli.video --warm_start: {len(flows)} finite .flo files; "
          f"cli.demo_image: {png} reads back", flush=True)

    # the loop's time per pair, after the runs above warmed it
    model = build_model(seed=0, precision="highest")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        V.validate_mpf(model, iters=ITERS, data_root=big)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / EVAL_PAIRS)
    clock = V.EvalClock()
    V.validate_mpf(model, iters=ITERS, data_root=big, clock=clock)
    stages = {k: v * 1e3 / clock.pairs for k, v in clock.seconds.items()}
    total = sum(stages.values())
    host = stages["read"] + stages["pad"] + stages["metrics"]
    ms = statistics.median(walls)
    print(f"  evaluation loop {H}x{W} iters {ITERS} fp32: median {ms:.2f} "
          f"ms/pair over 3 runs of {EVAL_PAIRS} pairs (min {min(walls):.2f}, "
          f"max {max(walls):.2f}); phase 4's forward {forward_ms:.2f} "
          f"ms/pair; stages with a synchronise after each (ms/pair): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f"; host share (read + pad + metrics) {100 * host / total:.1f}%",
          flush=True)
    return {"ms_per_pair": ms, "stages_ms_per_pair": stages,
            "host_share": host / total, "counts_per_pair": eval_counts,
            "card_vs_cpu_rel": worst, "batch_rel": bworst}


# -- phase 19: the training CLI --------------------------------------------------

TRAIN_CLI_FRAMES = 9      # EFTs_Car2000: 8 pairs, 2 batches of 4 per epoch
TRAIN_CLI_NUM_STEPS = 5   # --num_steps: 6 updates, checkpoints 3, 6, final
TRAIN_CLI_VAL_FREQ = 3
TRAIN_CLI_VAL_PAIRS = 3   # EFTs_Car100: 4 frames
TRAIN_CLI_TAGS = ["3", "6", "final", "logs"]
# a run resumed from tag 3 against the uninterrupted run: the distance of
# their final weights over the distance the uninterrupted run moved them in
# the same 3 steps (relative L2 over all tensors). Not bitwise on the card:
# the scatter's shared-memory f32 adds and cuDNN's weight-gradient sums
# land in any order, and Adam scales each gradient by its own running
# magnitude, so elements whose gradients are near zero move by up to the
# learning rate either way.
RESUME_RTOL = 5e-2
# the .pth run against the seeded run: the same weights, batch and noise
# at step 0, so the same loss but for the reductions' order
PTH_LOSS_RTOL = 1e-5


class StepLosses:
    """Keeps each training step's loss tensor (no synchronise) while the
    block runs ``cli.train``: ``Trainer.train_step`` is wrapped, and put
    back after."""

    def __enter__(self):
        from prior_flow_tpu_torch.train import trainer
        self.cls, self.orig, self.losses = trainer.Trainer, None, []
        self.orig = self.cls.train_step
        orig, losses = self.orig, self.losses

        def train_step(trainer_self, batch):
            m = orig(trainer_self, batch)
            losses.append(m["train/loss"].detach())
            return m

        self.cls.train_step = train_step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig

    def values(self):
        return [float(v) for v in self.losses]


def jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_cli_counts(mode: str, steps: int, validations: int,
                     panels: int) -> dict:
    """The launches of a CLI run: per step kernel 1 4 x ITERS, the sums 30
    and the scatter's grid entry 2 x 4 x ITERS (standard) or 8 (taped); per
    validated pair and per image panel a forward's 4 x ITERS and 15."""
    forwards = validations * TRAIN_CLI_VAL_PAIRS + panels
    per = 2 * LEVELS * (ITERS if mode == "standard" else 1)
    return forward_counts(
        dccl_level_lookup=LEVELS * ITERS * (steps + forwards),
        instance_norm_sums=30 * steps + 15 * forwards,
        dccl_level_scatter_grid=per * steps)


# loader batches timed per worker's prefetch depth (was 4: cut to pay for
# phase 25's taped, deferred and (d) cases)
LOADER_TIMED_DEPTHS = 2


def loader_ms_per_batch(tree: str, workers: int) -> float:
    """Host ms per batch of 4 (read two PNGs and a .flo per sample,
    augment, stack, pin) of the EFT loader at ``workers`` worker processes,
    each ``prefetch`` batches ahead: the wall time per batch of
    LOADER_TIMED_DEPTHS x depth batches taken as fast as they come, after
    depth = workers x prefetch untimed ones (the workers' start). At most
    depth batches are ready when the timing starts, so it reads at most
    1 / LOADER_TIMED_DEPTHS fast."""
    from prior_flow_tpu_torch.data import datasets
    from prior_flow_tpu_torch.data.loader import DataLoader
    loader = DataLoader(datasets.fetch_dataset("EFT", tree), TRAIN_B,
                        num_workers=workers)
    depth = workers * loader.prefetch
    stream = loader.infinite()
    try:
        for _ in range(depth):
            next(stream)
        t0 = time.perf_counter()
        for _ in range(LOADER_TIMED_DEPTHS * depth):
            next(stream)
        return (time.perf_counter() - t0) * 1e3 / (LOADER_TIMED_DEPTHS
                                                   * depth)
    finally:
        stream.close()


def phase_train_cli(dev, train):
    """``cli.train`` at the EFT recipe on a seeded synthetic MPF training
    tree, in-process, both grad modes: launch counts, finite losses and
    validation metrics, the checkpoint tags, train mode after validation,
    ``cli.evaluate`` on the final ``model.pth``, a run resumed from tag 3
    against the uninterrupted one, a ``module.``-prefixed ``.pth`` through
    ``--restore_ckpt``; the loop's card ms per step beside phase 9's bare
    step (``train``), the loader's wait per step and its host ms per
    batch, peak GB."""
    import shutil

    import numpy as np
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.checkpoint import load_pth, write_pth
    from prior_flow_tpu_torch.cli import evaluate
    from prior_flow_tpu_torch.cli import train as cli
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)

    base = os.path.join(REPO, "build", "phase19")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    tree = os.path.join(base, "mpf")
    rng = np.random.default_rng(19)
    write_mpf_scene(tree, "EFTs_Car2000", TRAIN_CLI_FRAMES, H, W, rng)
    write_mpf_scene(tree, "EFTs_Car100", TRAIN_CLI_VAL_PAIRS + 1, H, W, rng)
    seed = cli.build_parser().get_default("seed")
    pth = write_pth(build_model("cpu", seed=seed).state_dict(),
                    os.path.join(base, "seeded.pth"))
    print(f"  tree {H}x{W} ({TRAIN_CLI_FRAMES} training frames, "
          f"{TRAIN_CLI_VAL_PAIRS + 1} test frames) and a .pth written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    common = ["--stage", "EFT", "--data_root", tree, "--batch_size",
              str(TRAIN_B), "--iters", str(ITERS), "--mixed_precision",
              "--num_steps", str(TRAIN_CLI_NUM_STEPS), "--val_freq",
              str(TRAIN_CLI_VAL_FREQ), "--validation", "EFT", "--add_noise"]
    steps = TRAIN_CLI_NUM_STEPS + 1
    card = nvidia_smi("name,power.limit")

    def run(args, mode, want=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with StepLosses() as rec:
            trainer = cli.main(args + ["--grad_mode", mode])
        torch.cuda.synchronize()
        counts = launch_counts()
        if want is not None and counts != want:
            fail(f"cli.train {mode}: launch counts {counts}, expected {want}")
        losses = rec.values()
        if not all(math.isfinite(v) for v in losses):
            fail(f"cli.train {mode}: losses {losses}")
        return trainer, counts, losses, torch.cuda.max_memory_allocated() / 1e9

    out = {}
    for mode in ("standard", "taped"):
        save = os.path.join(base, f"ckpt_{mode}")
        want = train_cli_counts(mode, steps, 2, 1)
        trainer, counts, losses, peak = run(common + ["--save_path", save],
                                            mode, want)
        tags = sorted(os.listdir(save))
        if tags != TRAIN_CLI_TAGS or trainer.step != steps:
            fail(f"cli.train {mode}: tags {tags}, step {trainer.step}")
        if not trainer.model.training:
            fail(f"cli.train {mode}: the model left validation in eval mode")
        records = jsonl(os.path.join(save, "logs", "EFT.jsonl"))
        val = [r for r in records if "EFT-epe" in r]
        logged = [v for r in records for k, v in r.items() if k != "ts"]
        if [r["step"] for r in val] != [2, 5] or not all(
                math.isfinite(v) for v in logged):
            fail(f"cli.train {mode}: log records {records}")
        step_ms = trainer.clock.step_ms()
        gap_ms = trainer.clock.gap_ms()
        wait_ms = [w * 1e3 for w in trainer.clock.wait_s]
        med = statistics.median(step_ms[2:])
        wait = statistics.median(wait_ms[1:])
        out[mode] = dict(ms=med, wait_ms=wait, first_wait_ms=wait_ms[0],
                         gap_ms=gap_ms, peak_gb=peak, counts=counts,
                         losses=losses, val=val, save=save,
                         weights={k: v.detach().clone() for k, v in
                                  trainer.model.state_dict().items()})
        print(f"  cli.train {mode} {H}x{W} batch {TRAIN_B} iters {ITERS} "
              f"bf16, {steps} steps, 2 validations of "
              f"{TRAIN_CLI_VAL_PAIRS} pairs: tags {tags}; launches "
              f"{dict((k, v) for k, v in counts.items() if v)}; losses "
              f"{[round(v, 4) for v in losses]}; validation "
              f"{[(r['EFT-epe'], r['EFT-SEPE']) for r in val]}", flush=True)
        print(f"    [{card}] loop {med:.1f} ms/step on the card's clock "
              f"(median of steps 3-{steps}; each {[round(v, 1) for v in step_ms]}"
              f"), phase 9's bare step {train[mode]['ms']:.1f} ms/step "
              f"({100 * (med / train[mode]['ms'] - 1):+.1f}%); loader wait "
              f"{wait:.2f} ms/step (median after the first; first "
              f"{wait_ms[0]:.1f} ms with the workers' start; each "
              f"{[round(v, 2) for v in wait_ms]}); card idle between steps "
              f"{[round(v, 1) for v in gap_ms]} ms (after step 1 the log "
              f"and the image panels, after step 3 a checkpoint and a "
              f"validation); peak {peak:.2f} GB", flush=True)
        del trainer
        torch.cuda.empty_cache()

    std = out["standard"]
    res, counted = run_counted(
        lambda: evaluate.main(["--model", os.path.join(
            std["save"], "final", "model.pth"), "--dataset", "MPFDataset",
            "--scene", "EFT", "--data_root", tree, "--mixed_precision"]),
        forward_counts(dccl_level_lookup=LEVELS * ITERS),
        TRAIN_CLI_VAL_PAIRS, "cli.evaluate on the final model.pth")
    if not all(math.isfinite(v) for v in res.values()):
        fail(f"cli.evaluate on the final model.pth: {res}")
    print(f"  cli.evaluate --model final/model.pth: {res}", flush=True)

    # resumed from tag 3 against the uninterrupted standard run
    resumed, _, r_losses, _ = run(common + [
        "--save_path", os.path.join(base, "resumed"), "--restore_ckpt",
        os.path.join(std["save"], "3")], "standard")
    if resumed.step != steps:
        fail(f"resumed run ended at step {resumed.step}")
    at3 = load_pth(os.path.join(std["save"], "3", "model.pth"))
    num = den = 0.0
    for k, v in resumed.model.state_dict().items():
        full = std["weights"][k].double()
        num += float(((v.double() - full) ** 2).sum())
        den += float(((full - at3[k].to(full)) ** 2).sum())
    rel = math.sqrt(num / den)
    loss_rel = [abs(a - b) / abs(b) for a, b in
                zip(r_losses, std["losses"][3:])]
    if not rel <= RESUME_RTOL:
        fail(f"resumed from tag 3: final weights {rel:.3e} of the 3 steps' "
             f"movement from the uninterrupted run's (gate {RESUME_RTOL})")
    print(f"  resumed from tag 3: final weights {rel:.3e} of the last 3 "
          f"steps' movement from the uninterrupted run's (gate "
          f"{RESUME_RTOL}); its losses against the uninterrupted steps 4-6, "
          f"relative {[f'{v:.2e}' for v in loss_rel]}", flush=True)
    del resumed
    torch.cuda.empty_cache()

    # the seeded weights through a module.-prefixed .pth: step 0's loss is
    # the seeded run's
    _, _, p_losses, _ = run(common + [
        "--save_path", os.path.join(base, "from_pth"), "--restore_ckpt",
        pth, "--num_steps", "0"], "standard")
    p_rel = abs(p_losses[0] - std["losses"][0]) / abs(std["losses"][0])
    if len(p_losses) != 1 or p_rel > PTH_LOSS_RTOL:
        fail(f"--restore_ckpt {pth}: losses {p_losses} against the seeded "
             f"run's first {std['losses'][0]} (gate {PTH_LOSS_RTOL})")
    print(f"  --restore_ckpt seeded.pth (module. prefix): step 0 loss "
          f"{p_losses[0]:.6f}, the seeded run's {std['losses'][0]:.6f} "
          f"(relative {p_rel:.2e}, gate {PTH_LOSS_RTOL})", flush=True)

    host = {w: loader_ms_per_batch(tree, w) for w in (1, 4)}
    print(f"  [{card}] loader host ms per batch of {TRAIN_B} (read, augment, "
          f"stack, pin): 1 worker {host[1]:.1f}, 4 workers (the default) "
          f"{host[4]:.1f}", flush=True)
    return {"ms_per_step": {m: out[m]["ms"] for m in out},
            "bare_ms_per_step": {m: train[m]["ms"] for m in out},
            "loader_wait_ms_per_step": {m: out[m]["wait_ms"] for m in out},
            "card_idle_between_steps_ms": {m: out[m]["gap_ms"] for m in out},
            "peak_gb": {m: out[m]["peak_gb"] for m in out},
            "loader_host_ms_per_batch": host, "resume_rel": rel,
            "counts": {m: out[m]["counts"] for m in out}}


# -- phase 20: serving -------------------------------------------------------------

# the forward's kernels, PERF.md rows 1-5, which run as priorflow:: ops
SERVED = ("dccl_level_lookup", "instance_norm_sums",
          "dccl_level_lookup_coords", "dccl_lookup_all_levels",
          "dccl_cross_coords")
SERVING_DIR = os.path.join(REPO, "build", "phase20")
# the exported program against eager (JAX's tests/test_serving.py atol;
# the same ATen ops in the same order, so bitwise is expected)
SERVING_ATOL = 1e-5
# the AOTInductor packages against eager, x flow scale, each strictly
# below a fraction of the distance d one step down in precision puts
# eager from itself at the same seed and depth (fp32: TF32 convolutions;
# bf16: the fp32 forward), the packages called with TF32 on for cuDNN
# (torch's default), so a package run outside its recorded precision lies
# ~d away. The random-weight 12-iteration forward at 512x1024 is chaotic
# (1e-3 grey levels added to one image move its flow by 3.9e-3 of the
# flow scale), so each precision is also compiled at one iteration, where
# it is not. Readings (prior_flow_tpu_torch/tools/serving_precision.py,
# PERF.md §6, an H100), seed 0: fp32 3.7e-6 (1 iteration) and 3.8e-3 (12)
# against d 8.9e-4 and 1.19e-2; bf16 6.0e-3 and 1.30e-2 against d 1.33e-2
# and 2.08e-2, where an fp32 package reads 0.99 d. At 12 iterations no
# distance tells bf16 from fp32: there the kernels' names do
# (``precision_by_name``).
SERVING_DEPTHS = (ITERS, 1)
SERVING_GATE = {("fp32", ITERS): 0.5, ("fp32", 1): 0.5,
                ("bf16", ITERS): 1.0, ("bf16", 1): 0.75}
# at one iteration the fp32 package also meets the card-vs-CPU gate
SERVING_AOT_TOL = CARD_CPU_TOL
# cli.export --check, JAX's absolute gate
SERVING_CHECK_ATOL = 1e-3
# AOTInductor links a package with -fopenmp: the system g++ links libgomp,
# which a $CXX of another toolchain may lack
SERVING_CXX = "/usr/bin/g++"
# compiles one package with serving.aot_compile, in a process of its own
SERVING_COMPILE = """
import json, sys, time, torch
from prior_flow_tpu_torch import build_model, serving
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
path, tag, h, w, iters = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:])
model = build_model(seed=0, mixed_precision=tag == "bf16", precision="highest")
t0 = time.perf_counter()
serving.aot_compile(model, model.state_dict(), (1, h, w), iters,
                    package_path=path)
print(json.dumps({"compile_s": time.perf_counter() - t0}))
"""
# runs the saved programs in a process that never imports the model code
SERVING_LOAD = """
import json, sys, torch
from prior_flow_tpu_torch import serving
from prior_flow_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
out = {"counts": {}}
for tag in sys.argv[2:]:
    fn = serving.load_exported(f"{sys.argv[1]}/{tag}.pt2")
    inputs = torch.load(f"{sys.argv[1]}/inputs_{tag}.pt", weights_only=True)
    fn(inputs["state"], *inputs["images"])
    torch.cuda.synchronize()
    reset_launch_counts()
    flow = fn(inputs["state"], *inputs["images"])
    torch.cuda.synchronize()
    out["counts"][tag] = launch_counts()
    torch.save(flow.cpu(), f"{sys.argv[1]}/flow_{tag}.pt")
out["modules"] = sorted(m for m in sys.modules if m.startswith(
    ("prior_flow_tpu_torch.models", "prior_flow_tpu.", "jax")))
print(json.dumps(out))
"""


# phase 20's checks that need nothing of the main process, each run in a
# process of its own beside the compiles (``start_serving_side``): one of
# the ``serving_*_job`` functions below, its result as the last line
SERVING_SIDE = """
import json, sys
import chip_smoke
print(json.dumps({"result": getattr(chip_smoke, sys.argv[1])()}))
"""
SERVING_SIDE_JOBS = ("serving_opcheck_job", "serving_export_hr_job",
                     "serving_cli_check_job")
SERVING_HR = os.path.join(SERVING_DIR, f"fp32_{H2}x{W2}.pt2")


def side_device():
    """The card, with TF32 off as ``main`` sets it, for a side job."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def serving_opcheck_job() -> list:
    from prior_flow_tpu_torch.geometry import rotation_grids
    dev = side_device()
    return serving_opcheck(dev, rotation_grids(H, W).to_device(dev),
                           rotation_grids(H2, W2).to_device(dev))


def serving_export_hr_job() -> float:
    """Exports the 1024x2048 fp32 forward to SERVING_HR; its seconds."""
    from prior_flow_tpu_torch import build_model, serving
    side_device()
    model = build_model(seed=0, precision="highest")
    t0 = time.perf_counter()
    serving.save_exported(serving.export_forward(
        model, model.state_dict(), (1, H2, W2), ITERS), SERVING_HR)
    return time.perf_counter() - t0


def serving_cli_check_job() -> list:
    """``cli.export --check`` on a seeded .pth: the CLI's JSON lines."""
    import io
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.checkpoint import write_pth
    from prior_flow_tpu_torch.cli import export as export_cli
    side_device()
    pth = write_pth(build_model("cpu", seed=0).state_dict(),
                    os.path.join(SERVING_DIR, "seed0.pth"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        export_cli.main(["--model", pth, "--output",
                         os.path.join(SERVING_DIR, "cli.pt2"), "--size",
                         str(H), str(W), "--iters", str(ITERS), "--check"])
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def start_jobs(argv_of: dict, env: dict, base: str) -> dict:
    """Starts one process per entry of ``argv_of`` (name -> argv), each
    writing its output to ``base`` + name + ".out" / ".err"; returns
    name -> (process, that path stem) and registers their kill at this
    process's exit."""
    import atexit
    import subprocess
    jobs = {}
    for name, argv in argv_of.items():
        stem = base + ("_".join(map(str, name)) if isinstance(name, tuple)
                       else name)
        with open(stem + ".out", "w") as out, open(stem + ".err", "w") as err:
            jobs[name] = (subprocess.Popen(argv, cwd=REPO, env=env,
                                           stdout=out, stderr=err), stem)

    def stop():
        for proc, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return jobs


def job_output(name, job, what: str) -> str:
    """Waits for ``job`` and returns its standard output; fails with the
    end of its standard error if it failed."""
    proc, stem = job
    proc.wait(timeout=1800)
    if proc.returncode != 0:
        with open(stem + ".err") as f:
            fail(f"{what} {name} failed:\n{f.read()[-3000:]}")
    with open(stem + ".out") as f:
        return f.read()


def pair_ms(fn, runs: int = 7) -> float:
    """Median host ms of ``fn`` ending in a synchronise, after one
    warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serving_opcheck(dev, grids, grids2) -> list:
    """``torch.library.opcheck`` of each priorflow:: op on CUDA tensors:
    the lookup (per level and fused) at the 512x1024 level shapes, row 3
    at level 0 of 512x1024 and 1024x2048, the coords at both sizes, the
    sums at the first fnet norm's shape; f32 and bf16 volumes."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import library
    scales = [1.0 / 2 ** lvl for lvl in range(LEVELS)]
    done = []

    def check(op, args, what):
        torch.library.opcheck(op, args)
        torch.cuda.synchronize()
        done.append(what)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        levels = [lookup_inputs(lvl, dtype, dev, grids)
                  for lvl in range(LEVELS)]
        vA, vB = [lv[0] for lv in levels], [lv[1] for lv in levels]
        cA, cB, gA, gB = levels[0][2:]
        for fuse in (False, True):
            check(library.dccl_lookup_levels,
                  (vA, vB, cA, cB, gA, gB, scales, fuse),
                  f"dccl_lookup_levels {tag} fuse={fuse} {H}x{W}")
        del levels, vA, vB
        for size, gr in (((H, W), grids), ((H2, W2), grids2)):
            vA0, vB0, cA, cB, gA, gB = lookup_inputs(0, dtype, dev, gr,
                                                     size=size)
            xy = [c.reshape(1, -1, 81)
                  for c in library.dccl_cross_coords(cA, cB, gA, gB, [1.0])]
            check(library.dccl_level_lookup_coords,
                  (vA0, vB0, cA, cB, 1.0, *xy),
                  f"dccl_level_lookup_coords {tag} level 0 "
                  f"{size[0]}x{size[1]}")
            del vA0, vB0, xy
            torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(20)
        x = torch.randn(FNET_SHAPES[0], generator=g, device=dev).to(dtype)
        check(library.instance_norm_sums, (x, x),
              f"instance_norm_sums {tag} {tuple(x.shape)}")
    for size, gr in (((H, W), grids), ((H2, W2), grids2)):
        Q = size[0] // 8 * size[1] // 8
        cA, cB = (train_centres(dev, Q, seed, size).reshape(1, Q, 2)
                  for seed in (7, 8))
        check(library.dccl_cross_coords,
              (cA, cB, gr.a2b_w2c_8, gr.b2a_w2c_8, scales),
              f"dccl_cross_coords {size[0]}x{size[1]}")
    return done


@contextlib.contextmanager
def tf32_convolutions():
    """torch's default flags, TF32 on for cuDNN convolutions, which this
    script otherwise turns off."""
    import torch
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = False


def eager_refs(seed: int, iters: int, i1, i2) -> dict:
    """The seeded 512x1024 forward's flow at each precision: fp32
    ``precision="highest"``, TF32 convolutions (``precision=None`` at
    torch's default flags) and bf16; and ``d``, the distance (/ flow scale)
    one step down in precision puts it from itself: fp32 to TF32, bf16 to
    fp32."""
    import torch
    from prior_flow_tpu_torch.tools.serving_precision import (REFS,
                                                              eager_model,
                                                              ratio)
    flows = {}
    for ref in REFS:
        model = eager_model(ref, seed, "cuda")
        with tf32_convolutions(), torch.no_grad():
            flows[ref] = model(i1, i2, iters=iters)
    flows["d"] = {"fp32": ratio(flows["tf32"], flows["fp32"]),
                  "bf16": ratio(flows["bf16"], flows["fp32"])}
    return flows


def conv_kernels(fn) -> dict:
    """{name: launches} of the cuDNN convolution kernels of one profiled
    call of ``fn``, with TF32 on for cuDNN (torch's default)."""
    from prior_flow_tpu_torch.tools import serving_precision
    with tf32_convolutions():
        return serving_precision.conv_kernels(
            serving_precision.kernel_events(fn))


def start_serving_compiles() -> dict:
    """Starts phase 20's four AOTInductor package compiles, each in a
    process of its own writing its output to files beside its package.
    They take minutes side by side (phase 20 prints their seconds), so
    they start before phase 18, after the kernel timings of phases 2-17:
    phases 18 and 19, whose host times are reported and not gated, run
    beside them and share the host's cores with them.
    Returns the jobs (``start_jobs``: killed when this process exits, so
    a failed phase leaves no compile behind), the packages, the start time
    and the environment."""
    os.makedirs(SERVING_DIR, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, CXX=SERVING_CXX)
    package = {(tag, iters): os.path.join(SERVING_DIR,
                                          f"{tag}_{iters}it_aoti.pt2")
               for tag in ("fp32", "bf16") for iters in SERVING_DEPTHS}
    t_compile = time.perf_counter()
    compiles = start_jobs(
        {key: [sys.executable, "-c", SERVING_COMPILE, path, key[0], str(H),
               str(W), str(key[1])] for key, path in package.items()},
        env, os.path.join(SERVING_DIR, "compile_"))
    return dict(compiles=compiles, package=package, t=t_compile, env=env)


def phase_serving(dev, started: dict):
    """Phase 20: the serving path (``prior_flow_tpu_torch.serving``). The
    four AOTInductor packages compile in the processes that
    ``start_serving_compiles`` started, and the opcheck, the 1024x2048
    export and ``cli.export --check`` run in processes of their own
    (SERVING_SIDE_JOBS), while this one checks the exported programs;
    every timing is taken after they have all finished."""
    print(f"  AOTInductor's C++ compiler: CXX={SERVING_CXX}", flush=True)
    return serving_checks(dev, started["compiles"], started["package"],
                          started["t"], started["env"])


def serving_checks(dev, compiles, package, t_compile, env):
    """Phase 20's checks, beside the compiles ``compiles`` ((precision,
    iterations) -> job) of ``package`` ((precision, iterations) -> path)
    and the side jobs it starts."""
    import subprocess
    import torch
    from prior_flow_tpu_torch import build_model, serving
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    from prior_flow_tpu_torch.tools.serving_precision import (
        eager_model, precision_by_name, ratio)

    def lap(what: str) -> None:
        print(f"  [{what}: {time.perf_counter() - t_compile:.1f} s after "
              f"the compiles started]", flush=True)

    side = start_jobs({name: [sys.executable, "-c", SERVING_SIDE, name]
                       for name in SERVING_SIDE_JOBS}, env,
                      os.path.join(SERVING_DIR, "side_"))
    lap("phase 20's checks begin")
    out = {}
    i1, i2 = (t.to(dev) for t in images(0, H, W))
    want = forward_counts(dccl_level_lookup=LEVELS * ITERS)
    models, live = {}, {}
    for tag in ("fp32", "bf16"):
        models[tag] = build_model(seed=0, mixed_precision=tag == "bf16",
                                  precision="highest")
        state = models[tag].state_dict()
        live[tag] = serving.make_forward(models[tag], ITERS)(state, i1, i2)
        t0 = time.perf_counter()
        exported = serving.export_forward(models[tag], state, (1, H, W),
                                          ITERS)
        out[tag] = {"export_s": time.perf_counter() - t0}
        serving.save_exported(exported,
                              os.path.join(SERVING_DIR, f"{tag}.pt2"))
        torch.save({"state": state, "images": (i1, i2)},
                   os.path.join(SERVING_DIR, f"inputs_{tag}.pt"))

    lap("exported")
    # the saved programs in a process without the model code
    proc = subprocess.run(
        [sys.executable, "-c", SERVING_LOAD, SERVING_DIR, "fp32", "bf16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"loading the exported programs failed:\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if res["modules"]:
        fail(f"load_exported imported {res['modules']}")
    for tag in ("fp32", "bf16"):
        flow = torch.load(os.path.join(SERVING_DIR, f"flow_{tag}.pt"),
                          weights_only=True)
        err = (flow - live[tag].cpu()).abs().max().item()
        print(f"  {tag} {H}x{W} exported program ({out[tag]['export_s']:.1f} "
              f"s to export), loaded without the model code: max abs err "
              f"{err:.3e} against eager (gate {SERVING_ATOL}); launches "
              f"{res['counts'][tag]}", flush=True)
        if err > SERVING_ATOL or res["counts"][tag] != want:
            fail(f"{tag} exported program departs from eager or launches "
                 f"{res['counts'][tag]}")
        out[tag]["export_err"] = err

    lap("loaded without the model code")
    side = {name: json.loads(job_output(name, job, "phase 20's side job")
                             .strip().splitlines()[-1])["result"]
            for name, job in side.items()}
    lap("the side jobs ended")
    out["opcheck"] = side["serving_opcheck_job"]
    print(f"  opcheck passed: {out['opcheck']}", flush=True)
    # the 1024x2048 planes route as an exported program
    model_hr = build_model(seed=0, precision="highest")
    state_hr = model_hr.state_dict()
    h1, h2 = (t.to(dev) for t in images(2, H2, W2))
    eager = model_hr(h1, h2, iters=ITERS)
    program_hr = serving.load_exported(SERVING_HR)
    program_hr(state_hr, h1, h2)
    torch.cuda.synchronize()
    reset_launch_counts()
    flow = program_hr(state_hr, h1, h2)
    torch.cuda.synchronize()
    counts = launch_counts()
    want_hr = forward_counts(dccl_level_lookup_coords=LEVELS * ITERS,
                             dccl_cross_coords=ITERS)
    same = bool(torch.equal(flow, eager))
    print(f"  fp32 {H2}x{W2} exported program "
          f"({side['serving_export_hr_job']:.1f} s to export): bitwise eager "
          f"{same} (max abs diff {(flow - eager).abs().max().item():.3e}); "
          f"launches {counts}", flush=True)
    if not same or counts != want_hr:
        fail(f"the {H2}x{W2} exported program: bitwise {same}, launches "
             f"{counts}, expected {want_hr}")
    out["hr"] = {"counts": counts}
    del eager, flow

    # the export CLI with --check on a seeded .pth
    lines = side["serving_cli_check_job"]
    print(f"  cli.export --check: {lines}", flush=True)
    if not (lines[0]["platforms"] == ["cuda"]
            and lines[1]["check_max_abs_err"] < SERVING_CHECK_ATOL):
        fail(f"cli.export --check: {lines}")
    out["cli_check_err"] = lines[1]["check_max_abs_err"]

    lap(f"the {H2}x{W2} program and cli.export --check")
    # the eager references: each seed and depth at each precision
    refs = {(seed, iters): eager_refs(seed, iters, i1, i2)
            for seed in (0, 1) for iters in SERVING_DEPTHS}
    bound = {f"seed{seed}_{iters}it": refs[seed, iters]["d"]
             for seed, iters in refs}
    sensitivity = ratio(models["fp32"](i1 + 1e-3, i2, iters=ITERS),
                        live["fp32"])
    print(f"  the fp32 forward with 1e-3 grey levels added to image 1: "
          f"{sensitivity:.3e} x flow scale from itself; one step down in "
          f"precision: {bound}", flush=True)
    # the kernel-name rules' controls: TF32 eager fails the fp32 rule,
    # bf16 eager passes the bf16 one
    control = {ref: conv_kernels(lambda: eager_model(ref, 0, dev)(
        i1, i2, iters=ITERS)) for ref in ("tf32", "bf16")}
    tf32_launches = sum(n for name, n in control["tf32"].items()
                        if "tf32" in name.lower())
    print(f"  eager's convolution launches: TF32 {tf32_launches} TF32 by "
          f"name of {sum(control['tf32'].values())}; bf16 "
          f"{sum(control['bf16'].values())}", flush=True)
    if (precision_by_name(control["tf32"], "fp32")
            or not precision_by_name(control["bf16"], "bf16")):
        fail(f"the kernel-name rules do not tell the precisions apart: "
             f"{control}")
    out["conv_kernels_eager"] = {ref: sum(c.values())
                                 for ref, c in control.items()}

    lap("the eager references and the kernel-name controls")
    # the packages
    for key, job in compiles.items():
        stdout = job_output(key, job, "the AOTInductor compile")
        lap(f"{key[0]} {key[1]}-iteration package compiled")
        out.setdefault(key[0], {})[f"compile_s_{key[1]}it"] = json.loads(
            stdout.strip().splitlines()[-1])["compile_s"]
    compile_wall = time.perf_counter() - t_compile
    out["compile_wall_s"] = compile_wall
    print(f"  four packages compiled in {compile_wall:.1f} s of wall time, "
          f"side by side: " + ", ".join(
              f"{tag} {out[tag][f'compile_s_{it}it']:.1f} s ({it} it)"
              for tag, it in package), flush=True)
    states = {(tag, seed): build_model(
        seed=seed, mixed_precision=tag == "bf16",
        precision="highest").state_dict()
        for tag in ("fp32", "bf16") for seed in (0, 1)}
    for tag, iters in package:
        compiled = serving.export.CompiledForward(package[tag, iters])
        state = states[tag, 0]
        errs, gates = [], []
        with tf32_convolutions():
            for seed in (0, 1):
                got = compiled(states[tag, seed], i1, i2)
                torch.cuda.synchronize()
                errs.append(ratio(got, refs[seed, iters][tag]))
                gates.append(SERVING_GATE[tag, iters]
                             * refs[seed, iters]["d"][tag])
                tol = SERVING_AOT_TOL if (tag, iters) == ("fp32", 1) else 1
                if not (tuple(got.shape) == (1, H, W, 2)
                        and bool(torch.isfinite(got).all())
                        and errs[-1] < gates[-1] and errs[-1] <= tol):
                    fail(f"{tag} {iters}-iteration AOTInductor package, "
                         f"seed {seed}: {errs[-1]:.3e} x flow scale from "
                         f"eager (gate {gates[-1]:.3e})")
            moved = ratio(compiled(states[tag, 1], i1, i2),
                          compiled(state, i1, i2))
            if moved < max(gates):
                fail(f"{tag} package: the second state moved the flow by "
                     f"{moved:.3e} only")
            reset_launch_counts()
            got = compiled(state, i1, i2)
            torch.cuda.synchronize()
            counts = launch_counts()
        want_it = forward_counts(dccl_level_lookup=LEVELS * iters)
        if counts != want_it:
            fail(f"{tag} {iters}-iteration AOTInductor package: launch "
                 f"counts {counts}, expected {want_it}")
        out[tag][f"aot_err_{iters}it"] = errs
        out[tag][f"aot_gate_{iters}it"] = gates
        print(f"  {tag} {H}x{W} iters {iters} AOTInductor package: seeds "
              f"0 / 1 {errs[0]:.3e} / {errs[1]:.3e} x flow scale from eager "
              f"(gates {gates[0]:.3e} / {gates[1]:.3e}); launches per call "
              f"{LEVELS * iters} kernel-1, 15 sums", flush=True)
        if iters != ITERS:
            del compiled
            continue
        names = conv_kernels(lambda: compiled(state, i1, i2))
        if not precision_by_name(names, tag):
            fail(f"{tag} package's convolution kernels: {names}")
        out[tag].update(counts=counts, conv_kernels=names)
        # the ops launch on the stream the package runs on
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            on_side = compiled(state, i1, i2)
        torch.cuda.synchronize()
        if not torch.equal(on_side, got):
            fail(f"{tag} AOTInductor package on a side stream departs by "
                 f"{(on_side - got).abs().max().item()}")
        for what, args in (
                ("batch 2", (state, i1.expand(2, -1, -1, -1).contiguous(),
                             i2.expand(2, -1, -1, -1).contiguous())),
                ("float64 images", (state, i1.double(), i2.double())),
                ("images on the CPU", (state, i1.cpu(), i2.cpu()))):
            try:
                compiled(*args)
            except ValueError:
                continue
            fail(f"{tag} AOTInductor package ran {what}")
        model = models[tag]
        program = serving.load_exported(os.path.join(SERVING_DIR,
                                                     f"{tag}.pt2"))
        ms = {"eager": pair_ms(lambda: model(i1, i2, iters=ITERS)),
              "exported": pair_ms(lambda: program(state, i1, i2)),
              "aot": pair_ms(lambda: compiled(state, i1, i2))}
        print(f"  {tag} package: {sum(names.values())} convolution "
              f"launches, each {tag} by its kernel's name; bitwise the same "
              f"on a side stream; batch, dtype and device drift raise; "
              f"ms/pair (median of 7) eager {ms['eager']:.2f}, exported "
              f"{ms['exported']:.2f}, AOTInductor {ms['aot']:.2f}",
              flush=True)
        out[tag]["ms"] = ms
        if tag == "fp32" and precision_by_name(names, "bf16"):
            fail("the fp32 package's kernels pass as bf16 by name")
        del compiled, program, got, on_side
        torch.cuda.empty_cache()
    out["step_down"] = bound
    out["sensitivity"] = sensitivity
    del models, live, refs, states
    torch.cuda.empty_cache()

    # the 1024x2048 exported program's time, beside eager
    out["hr"]["ms"] = {
        "eager": pair_ms(lambda: model_hr(h1, h2, iters=ITERS), 5),
        "exported": pair_ms(lambda: program_hr(state_hr, h1, h2), 5)}
    print(f"  fp32 {H2}x{W2}: ms/pair (median of 5) eager "
          f"{out['hr']['ms']['eager']:.2f}, exported program "
          f"{out['hr']['ms']['exported']:.2f}", flush=True)
    return out


# -- phase 21: the memory-scale modes --------------------------------------------

# the on-the-fly forward's size: its 1/8 grid has Q = 131072 queries, where
# the two bf16 volume pyramids would outgrow the card
H3, W3 = 2048, 4096
# DCCLOnTheFly's fields against DCCLFused's on the same centres, of
# max|field|: exact by linearity, the routes differ in the f32 sums' order
SCALE_FIELD_RTOL = 1e-5
# the on-the-fly forward against the volume route's, 3 iterations, fp32:
# JAX's contract (tests/test_model.py:100-115), x flow scale + absolute
OTF_FLOW_RTOL = OTF_FLOW_ATOL = 1e-4
# a host time per pair above this many seconds is taken once after the
# warm-up instead of as the median of SCALE_RUNS
SLOW_PAIR_S = 30.0
SCALE_RUNS = 1      # was 3: cut to pay for phase 24
# rematerialisation against no remat at the first step: each gradient
# tensor within this multiple of the distance between two no-remat steps
# (the scatter's float atomics) plus JAX's remat rtol
# (tests/test_model.py:156-181) of its norm, floored as grad_floor does:
# "dots" computes some gradients in another order than no remat (1.1e-6
# of the norm on an H100) where two no-remat steps agree bitwise, and it
# moves the round-off that the zero-gradient fnet biases carry by more
# than the atomics do (on an H100 by up to 6% of their norm, 2.9 times
# the no-remat steps' distance)
REMAT_SPREAD_X = 2.0
REMAT_RTOL = 2e-4
REMAT_STEPS = 2     # was 5, then 3: cut to pay for phases 24 and 25
# the on-the-fly training step against the volume route's, 12 iterations:
# the random-weight recurrence amplifies any rounding (phase 20), so the
# reference distance is the one the volume route's step moves when its
# fields are quantised to a grid of 2^-OTF_ROUND_BITS of their max|field|
# (the size of the two routes' field difference in (a), 8.4e-7 of
# max|field| on an H100): the on-the-fly step's loss and global gradient
# distance within OTF_SENS_X times it (plus STEP_LOSS_RTOL and twice the
# two volume steps' spread)
OTF_ROUND_BITS = 20
OTF_SENS_X = 4.0
OTF_NTAP = 81
# f32 operations per (tap, corner, channel) of the on-the-fly taps: the
# dot's multiply-add
OTF_OPS_PER_TAP_CHANNEL = 2 * 4


def volume_pyramids_gb(h: int, w: int, itemsize: int = 2) -> float:
    """GB that both branches' volume pyramids of an (h, w) input take,
    stored in ``itemsize``-byte elements (bf16: 2)."""
    q = (h // 8) * (w // 8)
    cols = sum(((h // 8) >> lvl) * ((w // 8) >> lvl) for lvl in range(LEVELS))
    return 2 * q * cols * itemsize / 1e9


def scale_fmaps(dev, h: int, w: int, seed: int):
    """Unit-scale (1, h/8, w/8, 256) fmaps, four, and both branches'
    centres over the 1/8 grid and a margin of 2."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    h8, w8 = h // 8, w // 8
    fm = [torch.randn(1, h8, w8, 256, generator=g, device=dev)
          for _ in range(4)]
    cens = [torch.stack([torch.rand(1, h8, w8, generator=g, device=dev)
                         * (w8 + 4) - 2,
                         torch.rand(1, h8, w8, generator=g, device=dev)
                         * (h8 + 4) - 2], -1) for _ in range(2)]
    return fm, cens


def otf_window_rows(pyr_A, pyr_B, cens, grids) -> int:
    """The distinct f2 rows each query's tap window touches, summed over
    queries, levels, branches and sides (own and cross): the rows a tap
    kernel that reads each window's rows once must read. Counted from this
    run's centres and the coords the path uses, corners of zero weight
    left out."""
    import torch
    from prior_flow_tpu_torch.ops import corr
    B, Q, _ = cens[0].shape
    total = 0
    for q0, q1 in corr._query_chunks(Q, 0, corr.DCCLOnTheFly.QUERY_CHUNK_AUTO):
        coords = corr.OnTheFlyTaps._coords(
            *cens, *grids, tuple(1.0 / 2 ** i for i in range(LEVELS)), q0, q1)
        for lvl, sides in enumerate(coords):
            for j, b in enumerate(corr.SIDE_BRANCH):
                f2 = (pyr_A, pyr_B)[b][lvl][1]
                rows = torch.cat([torch.where(w != 0, idx, -1) for idx, w in
                                  corr._tap_rows(f2, *sides[j])], dim=-1)
                rows = rows.view(-1, rows.shape[-1]).sort(dim=-1).values
                new = torch.ones_like(rows, dtype=torch.bool)
                new[:, 1:] = rows[:, 1:] != rows[:, :-1]
                total += int((new & (rows >= 0)).sum())
    return total


def scale_fields(dev, peaks):
    """(a) One DCCLOnTheFly call against DCCLFused's own and cross fields
    (the volume route, the f32 chunked build) at 1024x2048 on the same
    seeded fmaps and centres; then the on-the-fly tap path alone
    (``OnTheFlyTaps``) at 2048x4096, timed per iteration, with its bound."""
    import torch
    from prior_flow_tpu_torch.geometry import rotation_grids
    from prior_flow_tpu_torch.ops import corr
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    out = {}
    fm, cens = scale_fmaps(dev, H2, W2, 21)
    g = rotation_grids(H2, W2).to_device(dev)
    args = (g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8, g.b2a_8)
    with torch.no_grad():
        vols = [corr.build_pyramid_lean(fm[i], fm[i + 1], LEVELS,
                                        torch.float32) for i in (0, 2)]
        ref = corr.DCCLFused(LEVELS)(*cens, *vols, *args)
        del vols
        torch.cuda.empty_cache()
        pyrs = [corr.DCCLOnTheFly.build_pyramid(fm[i], fm[i + 1], LEVELS)
                for i in (0, 2)]
        reset_launch_counts()
        got = corr.DCCLOnTheFly(LEVELS)(*cens, *pyrs, *args)
        torch.cuda.synchronize()
        counts = launch_counts()
    want = forward_counts(instance_norm_sums=0, dccl_cross_coords=2)
    if counts != want:
        fail(f"on-the-fly call {H2}x{W2}: launch counts {counts}, expected "
             f"{want}")
    worst = 0.0
    for name, a, r in zip(("own_A", "cross_A", "own_B", "cross_B"), got, ref):
        rel = (a - r).abs().max().item() / r.abs().max().item()
        worst = max(worst, rel)
        if not (torch.isfinite(a).all() and rel <= SCALE_FIELD_RTOL):
            fail(f"on-the-fly {name} at {H2}x{W2}: {rel:.3e} of max|field| "
                 f"from the volume route (gate {SCALE_FIELD_RTOL})")
    print(f"  (a) DCCLOnTheFly vs DCCLFused fields, {H2}x{W2}, f32: worst "
          f"{worst:.3e} of max|field| (gate {SCALE_FIELD_RTOL}); 2 coords "
          f"launches (2 query chunks)", flush=True)
    out["field_rel"] = worst
    del fm, cens, ref, got, pyrs
    torch.cuda.empty_cache()

    # the tap path alone at 2048x4096, one iteration
    fm, cens = scale_fmaps(dev, H3, W3, 22)
    g = rotation_grids(H3, W3).to_device(dev)
    B, h8, w8, C = fm[0].shape
    Q = h8 * w8
    cq = [c.reshape(B, Q, 2).contiguous() for c in cens]
    scales = tuple(1.0 / 2 ** i for i in range(LEVELS))
    chunks = corr._query_chunks(Q, 0, corr.DCCLOnTheFly.QUERY_CHUNK_AUTO)
    with torch.no_grad():
        pyrs = [corr.DCCLOnTheFly.build_pyramid(fm[i], fm[i + 1], LEVELS)
                for i in (0, 2)]
        f2s = [p[i][1] for i in range(LEVELS) for p in pyrs]
        grids = (g.a2b_w2c_8, g.b2a_w2c_8)
        call = lambda: corr.OnTheFlyTaps.apply(
            *cq, *grids, scales, chunks, pyrs[0][0][0], pyrs[1][0][0], *f2s)
        ms = cuda_ms(call, 1, warmup=1) * ITERS
        rows = otf_window_rows(*pyrs, cq, grids)
    taps = Q * OTF_NTAP * LEVELS * 4
    bytes_moved = (4 * LEVELS * Q * C * 4 + rows * C * 4
                   + 4 * Q * LEVELS * OTF_NTAP * 4) * ITERS
    ops = taps * C * OTF_OPS_PER_TAP_CHANNEL * ITERS
    bound_ms, bound_by = bound(bytes_moved, ops, peaks)
    print(f"  (a) the plain on-the-fly tap path at {H3}x{W3} (OnTheFlyTaps, "
          f"{len(chunks)} query chunks, {len(chunks)} coords launches per "
          f"iteration): {ms:.1f} ms per {ITERS}-iteration forward; bound "
          f"{bound_ms:.2f} ms ({bound_by}: {bytes_moved / 1e9:.1f} GB with "
          f"each window's {rows / (Q * LEVELS * 4):.1f} distinct f2 rows "
          f"read once, {ops / 1e12:.2f} TFLOP)", flush=True)
    out["tap_path"] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                           launches=len(chunks) * ITERS,
                           gb=bytes_moved / 1e9, tflop=ops / 1e12,
                           rows_per_window=rows / (Q * LEVELS * 4))
    del fm, cens, pyrs, f2s, cq
    torch.cuda.empty_cache()
    return out


def scale_forward_hr(dev):
    """(a) The 1024x2048 forward, fp32 ``precision="highest"``, one seeded
    pair, on-the-fly against the volume route: 3 iterations gated, 12
    reported."""
    import torch
    from prior_flow_tpu_torch import build_model
    i1, i2 = (t.to(dev) for t in images(5, H2, W2))
    out = {}
    flows = {}
    for mode in ("volume", "onthefly"):
        model = build_model(seed=0, precision="highest", corr_mode=mode)
        for iters in (3, ITERS):
            t0 = time.perf_counter()
            flows[mode, iters] = model(i1, i2, iters=iters)
            torch.cuda.synchronize()
            out[f"{mode}_{iters}_ms"] = (time.perf_counter() - t0) * 1e3
        del model
    for iters in (3, ITERS):
        ref, got = flows["volume", iters], flows["onthefly", iters]
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        out[f"ratio_{iters}"] = err / scale
        print(f"  (a) forward {H2}x{W2} fp32 {iters} iterations, on-the-fly vs "
              f"volume: max abs diff {err:.3e}, flow scale {scale:.3f}, ratio "
              f"{err / scale:.3e}" + (f" (gate {OTF_FLOW_RTOL} x scale + "
                                      f"{OTF_FLOW_ATOL})" if iters == 3 else
                                      " (reported)"), flush=True)
        if not torch.isfinite(got).all():
            fail(f"on-the-fly forward {H2}x{W2}: non-finite flow")
        if iters == 3 and err > OTF_FLOW_RTOL * scale + OTF_FLOW_ATOL:
            fail("the on-the-fly forward departs from the volume route")
    return out


def scale_kernels(dev):
    """Rows 2 and 5 at the shapes the 2048x4096 forward gives them: the
    sums kernel at its fnet norm shapes (FNET_SHAPES_BIG), f32 and bf16,
    within SUMS_RTOL / SUMS_ATOL of the plain version; the coords kernel
    on the first and the last 16384-query chunk of 2048x4096 centres
    (``OnTheFlyTaps._coords``' call: both branches, all levels, the
    rotation grids of 2048x4096), bitwise its plain version."""
    import torch
    from prior_flow_tpu_torch.geometry import rotation_grids
    from prior_flow_tpu_torch.ops import corr
    from prior_flow_tpu_torch.ops.kernels.dccl_coords import (
        dccl_cross_coords, dccl_cross_coords_plain)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in FNET_SHAPES_BIG:
            g = torch.Generator(device=dev).manual_seed(sum(shape))
            x = (torch.randn(shape, generator=g, device=dev) * 3
                 + 1.5).to(dtype)
            with torch.no_grad():
                err = sums_check(x, f"{H3}x{W3} {dtype} {shape}")
            errs[str(dtype), shape] = err
            del x
            torch.cuda.empty_cache()
    print(f"  (b) sums at the {H3}x{W3} fnet shapes {FNET_SHAPES_BIG}, f32 "
          f"and bf16: within rtol/atol {SUMS_RTOL} of the plain version, "
          f"max abs err {max(errs.values()):.3e}", flush=True)
    Q = (H3 // 8) * (W3 // 8)
    grid = rotation_grids(H3, W3).to_device(dev)
    gA, gB = grid.a2b_w2c_8, grid.b2a_w2c_8
    cA, cB = (train_centres(dev, Q, seed, (H3, W3)).reshape(1, Q, 2)
              for seed in (31, 32))
    scales = [1.0 / 2 ** lvl for lvl in range(LEVELS)]
    chunks = corr._query_chunks(Q, 0, corr.DCCLOnTheFly.QUERY_CHUNK_AUTO)
    for q0, q1 in (chunks[0], chunks[-1]):
        args = (cA[:, q0:q1].contiguous(), cB[:, q0:q1].contiguous(), gA, gB,
                scales)
        with torch.no_grad():
            got = dccl_cross_coords(*args)
            ref = dccl_cross_coords_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            fail(f"coords {H3}x{W3} queries {q0}:{q1}: not bitwise equal "
                 f"(max abs err {err})")
    print(f"  (b) coords at {H3}x{W3}, queries {chunks[0]} and {chunks[-1]} "
          f"(1, {chunks[0][1]}, 2), both branches, {LEVELS} levels: bitwise "
          f"equal to the plain version", flush=True)
    return dict(sums_err=max(errs.values()))


def scale_forward_big(dev):
    """(b) The 2048x4096 forward, batch 1, 12 iterations, bf16 mixed
    precision, ``corr_mode="onthefly"``: finite flow, launches per forward
    (15 sums, one coords launch per query chunk and iteration), peak GB,
    ms/pair."""
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.ops import corr
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    i1, i2 = (t.to(dev) for t in images(6, H3, W3))
    model = build_model(seed=0, mixed_precision=True, corr_mode="onthefly")
    Q = (H3 // 8) * (W3 // 8)
    chunks = len(corr._query_chunks(Q, 0, corr.DCCLOnTheFly.QUERY_CHUNK_AUTO))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    flow = model(i1, i2, iters=ITERS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = forward_counts(dccl_cross_coords=chunks * ITERS)
    if counts != want:
        fail(f"on-the-fly forward {H3}x{W3}: launch counts {counts}, "
             f"expected {want}")
    if tuple(flow.shape) != (1, H3, W3, 2) or not torch.isfinite(flow).all():
        fail(f"on-the-fly forward {H3}x{W3}: shape {tuple(flow.shape)} or "
             f"non-finite flow")
    runs = 1 if warm_s > SLOW_PAIR_S else SCALE_RUNS
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model(i1, i2, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    vol_gb = volume_pyramids_gb(H3, W3)
    print(f"  (b) forward {H3}x{W3} bf16 {ITERS} iterations, on-the-fly: "
          f"{ms:.1f} ms/pair ({'median of ' + str(runs) if runs > 1 else 'one run'}"
          f" after a {warm_s:.1f} s warm-up); peak {peak:.2f} GB; launches "
          f"{ {k: v for k, v in counts.items() if v} }; flow |max| "
          f"{flow.abs().max().item():.3f}; the volume route's bf16 pyramids "
          f"would take {vol_gb:.2f} GB (computed, not run)", flush=True)
    del model, flow
    torch.cuda.empty_cache()
    return dict(ms=ms, runs=runs, warm_s=warm_s, peak_gb=peak, counts=counts,
                volume_gb=vol_gb, chunks=chunks)


def grad_distance(g, ref) -> dict:
    """Per tensor: ||g - ref|| (L2)."""
    return {n: (g[n] - r).norm().item() for n, r in ref.items()}


def scale_remat(dev):
    """(c) The EFT recipe step (512x1024, batch 4, 12 iterations, bf16) in
    both grad modes with remat off, ``dccl`` and ``dots``: peak GB and
    ms/step (median of REMAT_STEPS after one warm-up step); at the first
    step the loss within STEP_LOSS_RTOL and each gradient tensor within
    REMAT_SPREAD_X times the distance between two no-remat steps plus
    REMAT_RTOL of its norm (``grad_floor``'s floor under it); the
    launches per step those of no remat (the lookup not replayed)."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    batches = [train_batch(40 + i, TRAIN_B, H, W, dev)
               for i in range(REMAT_STEPS + 1)]
    out = {}
    for mode in ("standard", "taped"):
        per = 2 * LEVELS * (ITERS if mode == "standard" else 1)
        want = forward_counts(dccl_level_lookup=LEVELS * ITERS,
                              instance_norm_sums=30,
                              dccl_level_scatter_grid=per)
        first = {}
        for policy in ("off", "off_again", "dccl", "dots"):
            kw = (dict(remat=False) if policy.startswith("off")
                  else dict(remat_policy=policy))
            model, step = make_trainer(dev, mode, True, ITERS, **kw)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i, batch in enumerate(batches[:1 if policy == "off_again"
                                              else None]):
                reset_launch_counts()
                t0 = time.perf_counter()
                m = step(batch, i)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                counts = launch_counts()
                if counts != want:
                    fail(f"remat {policy} {mode} step {i}: launch counts "
                         f"{counts}, expected {want}")
                if i == 0:
                    first[policy] = (float(m["train/loss"]), grads_of(model))
                else:
                    times.append(dt)
            peak = torch.cuda.max_memory_allocated() / 1e9
            if times:
                out[mode, policy] = dict(ms=statistics.median(times),
                                         peak_gb=peak)
                print(f"  (c) train {mode} remat {policy}: median "
                      f"{out[mode, policy]['ms']:.1f} ms/step over "
                      f"{len(times)} after one warm-up (min {min(times):.1f}, "
                      f"max {max(times):.1f}); peak {peak:.2f} GB; launches "
                      f"per step as without remat", flush=True)
            del model, step
            torch.cuda.empty_cache()
        l_ref, g_ref = first["off"]
        spread = grad_distance(first["off_again"][1], g_ref)
        total = math.sqrt(sum(float((r.double() ** 2).sum())
                              for r in g_ref.values()))
        for policy in ("dccl", "dots"):
            loss, g = first[policy]
            if abs(loss - l_ref) > STEP_LOSS_RTOL * abs(l_ref):
                fail(f"remat {policy} {mode}: loss {loss} vs {l_ref}")
            dist = grad_distance(g, g_ref)
            worst = (0.0, "")
            for n, d in dist.items():
                gate = (REMAT_SPREAD_X * spread[n] + REMAT_RTOL
                        * max(g_ref[n].norm().item(), grad_floor(n, total)))
                if d > gate:
                    fail(f"remat {policy} {mode}: gradient {n} {d:.3e} from "
                         f"no remat, gate {gate:.3e} (two no-remat steps "
                         f"{spread[n]:.3e} apart)")
                if gate > 0:
                    worst = max(worst, (d / gate, n))
            out[mode, policy]["loss_diff"] = abs(loss - l_ref)
            out[mode, policy]["worst_of_gate"] = worst[0]
            print(f"  (c) {mode} remat {policy} vs off, first step: loss "
                  f"{loss:.6f} vs {l_ref:.6f}; worst gradient tensor at "
                  f"{worst[0]:.3f} of its gate ({worst[1]})", flush=True)
    return out


class QuantisedFields:
    """A DCCL lookup whose four fields are quantised to a grid of
    2^-bits of their max|field|, with the gradient passed straight
    through: the volume route perturbed by a rounding of a given size."""

    def __init__(self, dccl, bits: int):
        self.dccl, self.bits = dccl, bits

    def __call__(self, *args):
        import torch
        out = []
        for f in self.dccl(*args):
            step = f.detach().abs().max() * 2.0 ** -self.bits
            out.append(f + (torch.round(f / step) * step - f).detach())
        return tuple(out)


def global_distance(g, ref) -> float:
    return math.sqrt(sum(float(((g[n] - r).double() ** 2).sum())
                         for n, r in ref.items()))


def scale_train_onthefly(dev):
    """(d) One standard step at 512x1024, batch 1, 12 iterations, fp32
    ``precision="highest"``, remat ``dccl``, on the fly against the volume
    route: the loss and the global gradient distance within OTF_SENS_X
    times the distance a quantisation of the volume route's fields moves
    its step (see OTF_ROUND_BITS), plus two volume steps' spread; per
    tensor reported; launches (24 coords: forward and backward, 30 sums);
    peak GB and ms/step (the on-the-fly step's second)."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    batches = [train_batch(50 + i, 1, H, W, dev) for i in range(2)]
    first, res = {}, {}
    for name in ("volume", "volume_again", "volume_quantised", "onthefly"):
        mode = "onthefly" if name == "onthefly" else "volume"
        model, step = make_trainer(dev, "standard", False, ITERS,
                                   precision="highest", corr_mode=mode)
        if name == "volume_quantised":
            model.dccl = QuantisedFields(model.dccl, OTF_ROUND_BITS)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches[:2 if name == "onthefly" else 1]):
            reset_launch_counts()
            t0 = time.perf_counter()
            m = step(batch, i)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            if i == 0:
                first[name] = (float(m["train/loss"]), grads_of(model))
                counts = launch_counts()
        res[name] = dict(ms=dt, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         counts=counts)
        del model, step
        torch.cuda.empty_cache()
    want = forward_counts(instance_norm_sums=30, dccl_cross_coords=2 * ITERS)
    if res["onthefly"]["counts"] != want:
        fail(f"on-the-fly train step: launch counts {res['onthefly']['counts']}"
             f", expected {want}")
    l_ref, g_ref = first["volume"]
    loss, g = first["onthefly"]
    l_q, g_q = first["volume_quantised"]
    spread = global_distance(first["volume_again"][1], g_ref)
    sens = global_distance(g_q, g_ref)
    dist = global_distance(g, g_ref)
    norm = math.sqrt(sum(float((a.double() ** 2).sum())
                         for a in g_ref.values()))
    loss_gate = STEP_LOSS_RTOL * abs(l_ref) + OTF_SENS_X * abs(l_q - l_ref)
    grad_gate = REMAT_SPREAD_X * spread + OTF_SENS_X * sens
    def rel_of(grads):
        return {n: (grads[n] - r).norm().item() / max(r.norm().item(),
                                                      grad_floor(n, norm))
                for n, r in g_ref.items()}

    def worst_of(rel, prefix=""):
        names = [n for n in rel if n.startswith(prefix)]
        return max(names, key=rel.get)

    rel, rel_q = rel_of(g), rel_of(g_q)
    worst, worst_q = worst_of(rel), worst_of(rel_q)
    fnet, fnet_q = worst_of(rel, "fnet."), worst_of(rel_q, "fnet.")
    print(f"  (d) train standard {H}x{W} batch 1 fp32 remat dccl, on-the-fly "
          f"vs volume: loss {loss:.6f} vs {l_ref:.6f} (diff "
          f"{abs(loss - l_ref):.3e}, gate {loss_gate:.3e}; quantised fields "
          f"{abs(l_q - l_ref):.3e}); gradient distance {dist / norm:.3e} of "
          f"the norm (gate {grad_gate / norm:.3e}: quantised fields "
          f"{sens / norm:.3e}, two volume steps {spread / norm:.3e}); worst "
          f"tensor rel L2 {rel[worst]:.3e} ({worst}), quantised fields "
          f"{rel_q[worst_q]:.3e} ({worst_q}); worst fnet tensor "
          f"{rel[fnet]:.3e} ({fnet}), quantised fields {rel_q[fnet_q]:.3e} "
          f"({fnet_q}); on-the-fly "
          f"{res['onthefly']['ms']:.1f} ms/step, peak "
          f"{res['onthefly']['peak_gb']:.2f} GB; volume "
          f"{res['volume']['ms']:.1f} ms/step (first step), peak "
          f"{res['volume']['peak_gb']:.2f} GB", flush=True)
    if abs(loss - l_ref) > loss_gate or dist > grad_gate:
        fail("the on-the-fly training step departs from the volume route's")
    return dict(res=res, loss_rel=abs(loss - l_ref) / abs(l_ref),
                grad_rel=dist / norm, grad_gate=grad_gate / norm,
                sens=sens / norm, worst_tensor=rel[worst],
                worst_tensor_quantised=rel_q[worst_q], worst_fnet=rel[fnet],
                worst_fnet_quantised=rel_q[fnet_q])


def phase_scale(dev, peaks):
    """Phase 21: the memory-scale modes (a)-(d)."""
    out = scale_fields(dev, peaks)
    out["hr"] = scale_forward_hr(dev)
    out["big_kernels"] = scale_kernels(dev)
    out["big"] = scale_forward_big(dev)
    out["remat"] = scale_remat(dev)
    out["train_otf"] = scale_train_onthefly(dev)
    return out


# -- phase 22: data parallel ---------------------------------------------------

DP_RANKS = 2              # (b): ranks sharing the one card over gloo
# the global batch of (b) (was 4: cut to pay for phase 25's taped,
# deferred and (d) cases; the one-process fp32 reference step at batch 4
# took 30-38 s on the card, at batch 2 ~1 s)
DP_B = 2
DP_STEPS = 2              # (b): updates per mode; the first is the warm-up
DP_SPREAD_X = 2.0         # (a), (b): times the distance of two reference runs
DP_RTOL = 2e-4            # (b): of a tensor's norm, as phase 21's remat gate
DP_TIMEOUT_S = 600.0      # (b), (c): the spawned ranks' deadline
NCCL_SHARED_TIMEOUT_S = 120.0


def _flat(tensors) -> "torch.Tensor":
    import torch
    return torch.cat([t.detach().reshape(-1).float().cpu() for t in tensors])


def dp_world1(dev, tmp: str):
    """(a) ``Trainer.run`` for 2 updates at the EFT recipe (512x1024, batch
    4, 12 iterations, bf16, remat ``dccl``, standard) on a one-rank NCCL
    mesh against the same run without a mesh, twice. Gates: the metrics
    logged at the first update (its forward; not the grad norm, which
    follows the scatter's atomics) bitwise those without a mesh; the
    parameters after both updates bitwise, or where the two runs without
    a mesh differ (the scatter's atomics reorder f32 sums), within
    DP_SPREAD_X of their distance (the last update's metrics reported).
    Also the all-reduce's ms per step (the flat bucket of the model's
    gradients, CUDA events over 20 calls) and its bytes."""
    import torch
    from prior_flow_tpu_torch.parallel import (all_reduce_grads, close_mesh,
                                               make_mesh)
    from prior_flow_tpu_torch.train import Trainer, TrainerConfig
    batches = [train_batch(60 + i, TRAIN_B, H, W, dev) for i in range(2)]
    timing = ("train/grad_norm", "train/steps_per_sec")

    def run(mesh, tag):
        cfg = TrainerConfig(num_steps=1, batch_size=TRAIN_B, iters=ITERS,
                            mixed_precision=True, val_freq=10 ** 9,
                            save_path=os.path.join(tmp, tag))
        logged = {}
        trainer = Trainer(cfg, device=dev, mesh=mesh,
                          logger=lambda m, step: logged.update(m))
        m = trainer.run(batches)
        torch.cuda.synchronize()
        if trainer.step != 2:
            fail(f"phase 22 (a) {tag}: {trainer.step} updates, expected 2")
        first = {k: v for k, v in logged.items() if k not in timing}
        return (trainer, first, {k: float(v) for k, v in m.items()},
                _flat(trainer.model.parameters()))

    _, f_ref, m_ref, p_ref = run(None, "plain")
    mesh = make_mesh(1, device=dev, backend="nccl", rank=0,
                     init_method=f"file://{os.path.join(tmp, 'store')}")
    try:
        trainer, f_dp, m_dp, p_dp = run(mesh, "mesh")
        grads = [p.grad for p in trainer.model.parameters()]
        nbytes = all_reduce_grads(grads, mesh)
        ms = cuda_ms(lambda: all_reduce_grads(grads, mesh), 20)
        del trainer, grads
    finally:
        close_mesh(mesh)
    _, f_again, m_again, p_again = run(None, "again")
    torch.cuda.empty_cache()
    spread = (p_again - p_ref).norm().item()
    dist = (p_dp - p_ref).norm().item()
    bitwise = torch.equal(p_dp, p_ref)
    if f_dp != f_ref:
        fail(f"phase 22 (a): the first update's metrics on the one-rank "
             f"mesh {f_dp} differ from those without a mesh {f_ref} (two "
             f"runs without a mesh: {f_again == f_ref})")
    if torch.equal(p_again, p_ref) and not bitwise:
        fail(f"phase 22 (a): the one-rank NCCL run's parameters lie "
             f"{dist:.3e} from the run without a mesh; two runs without a "
             f"mesh agree bitwise")
    if dist > DP_SPREAD_X * spread:
        fail(f"phase 22 (a): the one-rank NCCL run lies {dist:.3e} from the "
             f"run without a mesh, two runs without a mesh {spread:.3e} "
             f"apart")
    last = {k: (m_dp[k] - m_ref[k], m_again[k] - m_ref[k]) for k in m_ref}
    print(f"  (a) one-rank NCCL mesh, Trainer.run 2 updates at the EFT "
          f"recipe: first update's metrics bitwise those without a mesh; "
          f"parameters {'bitwise' if bitwise else 'not bitwise'} ({dist:.3e} "
          f"apart; two runs without a mesh {spread:.3e}); last update's "
          f"metrics, mesh and second run minus the first: "
          + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in last.items())
          + f"; all-reduce of {nbytes / 1e6:.2f} MB of gradients {ms:.4f} "
          f"ms per step", flush=True)
    return dict(bitwise=bitwise, param_dist=dist, spread=spread,
                allreduce_ms=ms, grad_bytes=nbytes,
                loss=m_dp["train/loss"])


def shares_and_magnitudes(n: int, dev, case: dict, batch, **kw):
    """``dryrun.shares_summed`` and, per gradient tensor, the sum over the
    ranks of the shares' magnitudes: two orders of summing n shares lie
    within 2 (n - 1) f32 roundings of it apart, element by element."""
    import numpy as np
    import torch
    from prior_flow_tpu_torch.parallel.dryrun import RankShare, train_once
    total, mag, loss = None, None, 0.0
    for r in range(n):
        res = train_once(RankShare(r, n, dev), dev, case, batch, **kw)
        g = res["grads"]
        total = g if total is None else {k: total[k] + g[k] for k in total}
        mag = ({k: v.abs() for k, v in g.items()} if mag is None else
               {k: mag[k] + g[k].abs() for k in mag})
        loss += res["metrics"]["train/loss"]
        torch.cuda.empty_cache()
    return total, float(np.float32(loss)), mag


def dp_ranks(dev, n: int = DP_RANKS, device="cuda:0", backend="gloo",
             tag: str = "phase 22 (b)", label: str = "", after_refs=None):
    """(b) ``n`` spawned ranks (by default two sharing the card over gloo;
    ``device="cuda"``, NCCL: one card each), a global batch of
    max(DP_B, n), fp32 ``precision="highest"``, 12 iterations, standard
    and taped: each rank's all-reduced gradients before the clip and the
    loss against one process that sums the ranks' shares in rank order
    (twice: bitwise, else within DP_SPREAD_X of the two sums' distance;
    beyond two ranks the collective sums in its own order, which adds
    2 (n - 1) f32 roundings of the shares' magnitudes) and against the
    global-batch step (per tensor within DP_SPREAD_X times the sum's
    distance from it plus DP_RTOL of its norm); every rank's gradients
    and updated parameters bitwise rank 0's; per rank ms/step, peak GB
    and launches per step. This process computes the references on
    ``dev`` first (beside the ranks they would not fit one card), then
    calls ``after_refs`` (what is to run beside the ranks); ``label``
    says what else shares the ranks' card."""
    import torch
    from prior_flow_tpu_torch.parallel.dryrun import (rank_runs,
                                                      shares_summed, spawn,
                                                      synthetic_batch,
                                                      train_once)
    b = max(DP_B, n)
    batch = synthetic_batch(7, b, H, W)
    kw = dict(precision="highest")
    cases = [dict(grad_mode=m, iters=ITERS) for m in ("standard", "taped")]
    # the batch-statistics step on the data-only mesh: one row per rank
    bn_batch = synthetic_batch(13, b, *SP_BN_HW)
    bn_cases = [dict(mode="batch-statistics", grad_mode="standard",
                     iters=SP_SHORT, hw=SP_BN_HW, steps=1,
                     model=dict(bn_running_average=False))]
    refs = []
    t0 = time.perf_counter()
    bn_refs = space_step_refs(dev, bn_batch, bn_cases, kw,
                              key=("bn", 13, b))
    for case in cases:
        acc, loss, mag = shares_and_magnitudes(n, dev, case, batch, **kw)
        acc2, loss2 = shares_summed(n, dev, case, batch, **kw)
        one = train_once(None, dev, case, batch, **kw)
        torch.cuda.empty_cache()
        order = 0.0 if n <= 2 else 2 * (n - 1) * 2.0 ** -24 * _flat(
            mag.values()).norm().item()
        refs.append((acc, loss, acc2, loss2, one, order))
    t1 = time.perf_counter()
    if after_refs is not None:
        after_refs()
    runs = spawn(rank_runs, n, [
        ("rank_updates", (cases, batch, DP_STEPS, 0, kw)),
        ("rank_updates", (bn_cases, bn_batch, 1, 0, kw))],
        device=device, backend=backend, timeout_s=DP_TIMEOUT_S)
    ranks = [r[0] for r in runs]
    print(f"  {tag[tag.index('('):]} references {t1 - t0:.1f} s, the "
          f"ranks {time.perf_counter() - t1:.1f} s", flush=True)
    out = {"bn": space_step_gates([r[1] for r in runs], bn_refs, bn_cases,
                                  (n, 1), tag, "data-only", b)}
    for i, case in enumerate(cases):
        mode = case["grad_mode"]
        per = 2 * LEVELS * (ITERS if mode == "standard" else 1)
        want = {"dccl_level_lookup": LEVELS * ITERS, "instance_norm_sums": 30,
                "dccl_level_scatter_grid": per}
        acc, loss, acc2, loss2, one, order = refs[i]
        got = ranks[0][i]
        for r, res in enumerate(ranks):
            if not (res[i]["grads_same"] and res[i]["params_same"]):
                fail(f"{tag} {mode}: rank {r}'s gradients or parameters "
                     f"differ from rank 0's")
            if res[i]["launches"] != want:
                fail(f"{tag} {mode} rank {r}: launches per step "
                     f"{res[i]['launches']}, expected {want}")
        g = got["grads"]
        dist = _flat(g[k] - acc[k] for k in acc).norm().item()
        spread = _flat(acc2[k] - acc[k] for k in acc).norm().item()
        bitwise = all(torch.equal(g[k], acc[k]) for k in acc) and \
            got["metrics"]["train/loss"] == loss
        if not bitwise and (dist > DP_SPREAD_X * spread + order or abs(
                got["metrics"]["train/loss"] - loss)
                > DP_SPREAD_X * abs(loss2 - loss)):
            fail(f"{tag} {mode}: the all-reduced gradients lie {dist:.3e} "
                 f"from the summed shares, two sums {spread:.3e} apart, "
                 f"the summing order's bound {order:.3e}; loss "
                 f"{got['metrics']['train/loss']} against {loss} and "
                 f"{loss2}")
        worst = (0.0, "")
        ref = one["grads"]
        for k, r in ref.items():
            d = (g[k] - r).norm().item()
            gate = (DP_SPREAD_X * (acc[k] - r).norm().item()
                    + DP_RTOL * r.norm().item())
            if d > gate:
                fail(f"{tag} {mode}: gradient {k} {d:.3e} from the "
                     f"batch-{b} step, gate {gate:.3e}")
            if gate > 0:
                worst = max(worst, (d / gate, k))
        l1, l4 = got["metrics"]["train/loss"], one["metrics"]["train/loss"]
        if abs(l1 - l4) > STEP_LOSS_RTOL * abs(l4):
            fail(f"{tag} {mode}: loss {l1} against the batch-{b} step's {l4}")
        per_rank = [dict(ms=statistics.median(res[i]["ms"]),
                         peak_gb=res[i]["peak_gb"],
                         launches=res[i]["launches"]) for res in ranks]
        out[mode] = dict(bitwise=bitwise, dist=dist, spread=spread,
                         order_bound=order, worst_of_gate=worst[0], loss=l1, loss_ref=l4,
                         ranks=per_rank, launches=got["launches"])
        print(f"  {tag[tag.index('('):]} {n} {backend} ranks on {device}, "
              f"{mode}, fp32, batch {b}: all-reduced gradients "
              f"{'bitwise' if bitwise else 'not bitwise'} the summed shares "
              f"({dist:.3e} apart; two sums {spread:.3e}"
              + (f"; the summing order's bound {order:.3e}" if order else "")
              + "); against the "
              f"batch-{b} step worst tensor at {worst[0]:.3f} of its gate "
              f"({worst[1]}), loss {l1:.6f} vs {l4:.6f}; per rank{label} "
              + "; ".join(
                  f"rank {r}: {q['ms']:.1f} ms/step, peak {q['peak_gb']} GB"
                  for r, q in enumerate(per_rank))
              + f"; launches per step {got['launches']}", flush=True)
    return out


def dp_nccl_shared_card(dev):
    """Two NCCL ranks on one card: the run fails (NCCL refuses a device
    twice); no rank goes on alone."""
    from prior_flow_tpu_torch.parallel.dryrun import rank_updates, spawn
    t0 = time.perf_counter()
    try:
        spawn(rank_updates, 2, [], None, device="cuda:0", backend="nccl",
              timeout_s=NCCL_SHARED_TIMEOUT_S)
    except Exception as e:      # the ranks' failure, re-raised by spawn
        msg = str(e).strip().splitlines()
        print(f"  NCCL with two ranks on one card fails as it must "
              f"({time.perf_counter() - t0:.1f} s): {type(e).__name__}: "
              f"{msg[-1][:160] if msg else ''}", flush=True)
        return type(e).__name__
    fail("phase 22: NCCL ran two ranks on one card")


def phase_parallel(dev):
    """Phase 22: data parallel on one card, (a)-(c). (a) runs alone (its
    all-reduce is timed); the NCCL refusal and (c) (64x128) run beside
    (b)'s ranks, once (b)'s references are done."""
    import concurrent.futures
    import tempfile

    import torch
    from prior_flow_tpu_torch.parallel import dryrun_multichip

    def dryrun():
        t0 = time.perf_counter()
        res = dryrun_multichip(DP_RANKS, device="cuda:0", backend="gloo")
        return dict(loss=res["loss"], s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase22_") as tmp:
        out = {"world1": dp_world1(dev, tmp)}
    torch.cuda.empty_cache()
    out["world1"]["s"] = t1 = time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        side = []
        out["two_ranks"] = dp_ranks(
            dev, label=" (two processes share one card, beside this "
            "process and the NCCL refusal's and dryrun_multichip's ranks: "
            "no speed claim)", after_refs=lambda: side.extend(
                [pool.submit(dp_nccl_shared_card, dev), pool.submit(dryrun)]))
        out["nccl_shared"], out["dryrun"] = (f.result() for f in side)
    out["s"] = time.perf_counter() - t0
    print(f"  phase 22: {out['s']:.1f} s ((a) {t1:.1f} s; (b), the NCCL "
          f"refusal and (c) side by side {out['s'] - t1:.1f} s)", flush=True)
    return out


# -- phase 23: the lookup modes --------------------------------------------------

LOOKUP_FIELD_RTOL = 1e-5  # of max|field|, per DCCL call
MODE_FLOW_RTOL = MODE_FLOW_ATOL = 1e-4
MODE_RUNS = 3
# the mxu program's size and depth (EXPORT_ITERS was 2: cut to pay for
# phase 25's taped, deferred and (d) cases; the export traces each
# iteration, ~10-19 s apiece)
EXPORT_HW, EXPORT_ITERS = (64, 128), 1
EXPORT_ATOL = 1e-5


def graph_ms(fn, n: int = 20) -> float:
    """Mean ms per replay of ``fn()`` captured in a CUDA graph, by CUDA
    events: the card's time for a call that launches too many kernels to
    queue behind a spin (``queued_ms``), without the host's issue."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, n)


def mode_fields(dev, grids):
    """One DCCL call at 512x1024, f32 unit-scale volumes, seeded centres
    over the image and a margin (no x a hair below 0, where the one-hot
    window and the samplers part, ROADMAP Queue 3): ``mxu`` and
    ``gather``, one branch per call, against ``DCCLFused``'s four fields;
    the mxu call's ms (both branches) issued back to back and replayed
    from a CUDA graph (its ~2000 launches do not fit the card's queue).

    ``gather`` takes the kernel route's window coords (centre + offset,
    wrapped) and is gated at LOOKUP_FIELD_RTOL of max|field|. ``mxu``
    takes JAX's one-hot window (the wrapped centre's fraction, then the
    offsets), which rounds the window coords otherwise in f32 (ROADMAP
    Queue 3): each of its fields is gated at the larger of that and the
    distance that moving every centre by one f32 ulp moves the kernel
    route's field (the sensitivity of the fields to a rounding of the
    coords)."""
    import torch
    from prior_flow_tpu_torch.ops.corr import DCCL, DCCLFused
    ins = [lookup_inputs(lvl, torch.float32, dev, grids) for lvl in
           range(LEVELS)]
    h8, w8 = H // 8, W // 8
    g = torch.Generator(device=dev).manual_seed(23)
    cens = [torch.stack([torch.rand(1, h8, w8, generator=g, device=dev)
                         * (w8 + 4) - 2,
                         torch.rand(1, h8, w8, generator=g, device=dev)
                         * (h8 + 4) - 2], -1) for _ in range(2)]
    pA, pB = [i[0] for i in ins], [i[1] for i in ins]
    out = {}
    gs = (grids.a2b_w2c_8, grids.b2a_w2c_8, grids.a2b_8, grids.b2a_8)
    with torch.no_grad():
        ref = DCCLFused(LEVELS)(*cens, pA, pB, *gs)
        up = [torch.nextafter(c, torch.full_like(c, math.inf)) for c in cens]
        ulp = [(a - b).abs().max().item() for a, b in zip(
            DCCLFused(LEVELS)(*up, pA, pB, *gs), ref)]
        for mode in ("mxu", "gather"):
            d = DCCL(LEVELS, lookup_mode=mode)

            def call():
                return (*d(cens[0], pA, pB, grids.a2b_w2c_8, grids.b2a_8),
                        *d(cens[1], pB, pA, grids.b2a_w2c_8, grids.a2b_8))
            got = call()
            worst, of_gate = 0.0, 0.0
            for name, a, b, u in zip(("own_A", "cross_A", "own_B",
                                      "cross_B"), got, ref, ulp):
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                gate = LOOKUP_FIELD_RTOL * scale
                if mode == "mxu":
                    gate = max(gate, u)
                worst = max(worst, err / scale)
                of_gate = max(of_gate, err / gate)
                if not err <= gate:
                    fail(f"phase 23 {mode} {name}: {err:.3e} from the kernel "
                         f"route, gate {gate:.3e} (one ulp of the centres "
                         f"moves it {u:.3e})")
            out[mode] = dict(field_rel=worst, of_gate=of_gate,
                             ms=cuda_ms(call, 10),
                             graph_ms=graph_ms(call) if mode == "mxu"
                             else None)
            print(f"  {mode} DCCL call at {H}x{W} (both branches): fields "
                  f"{worst:.3e} of max|field| from the kernel route, at "
                  f"{of_gate:.3f} of the gate (one ulp of the centres moves "
                  f"the kernel route's fields {max(ulp):.3e}); "
                  f"{out[mode]['ms']:.4f} ms issued back to back"
                  + (f", replayed from a CUDA graph (the card's time) "
                     f"{out[mode]['graph_ms']:.4f} ms" if mode == "mxu"
                     else ""), flush=True)
        out["ulp_move"] = ulp
    return out


def mode_forwards(dev):
    """The 512x1024 forward, batch 1, fp32 ``precision="highest"``, with
    ``lookup_mode`` mxu and gather against the kernel route: flow at 1 and
    3 iterations gated at JAX's 1e-4 x flow scale + 1e-4, at 12 reported;
    ms/pair (median of MODE_RUNS after the gated runs) and peak GB of
    each; the launches of one 12-iteration mxu forward."""
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    i1, i2 = (t.to(dev) for t in images(23, H, W))
    flows, out = {}, {}
    for mode in ("auto", "mxu", "gather"):
        model = build_model(seed=0, precision="highest", lookup_mode=mode)
        for iters in (1, 3):
            flows[mode, iters] = model(i1, i2, iters=iters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        flows[mode, ITERS] = model(i1, i2, iters=ITERS)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        times = []
        for _ in range(MODE_RUNS):
            t0 = time.perf_counter()
            model(i1, i2, iters=ITERS)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        want = forward_counts(**({"dccl_level_lookup": LEVELS * ITERS}
                                 if mode == "auto" else {}))
        if counts != want:
            fail(f"phase 23 {mode} forward: launches {counts}, expected "
                 f"{want}")
        out[mode] = dict(ms=statistics.median(times), peak_gb=peak,
                         counts=counts)
        del model
        torch.cuda.empty_cache()
    for mode in ("mxu", "gather"):
        for iters in (1, 3, ITERS):
            ref, got = flows["auto", iters], flows[mode, iters]
            scale = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            out[mode][f"ratio_{iters}"] = err / scale
            gated = iters != ITERS
            if not torch.isfinite(got).all() or (
                    gated and err > MODE_FLOW_RTOL * scale + MODE_FLOW_ATOL):
                fail(f"phase 23 {mode} forward, {iters} iterations: {err:.3e} "
                     f"from the kernel route (flow scale {scale:.3f})")
        print(f"  forward {H}x{W} fp32 lookup_mode={mode}: "
              f"{out[mode]['ms']:.2f} ms/pair (kernel route "
              f"{out['auto']['ms']:.2f}), peak {out[mode]['peak_gb']:.2f} GB "
              f"(kernel route {out['auto']['peak_gb']:.2f}); against the "
              f"kernel route / flow scale: 1 iteration "
              f"{out[mode]['ratio_1']:.3e}, 3 {out[mode]['ratio_3']:.3e} "
              f"(gate {MODE_FLOW_RTOL} x scale + {MODE_FLOW_ATOL}), "
              f"{ITERS} {out[mode][f'ratio_{ITERS}']:.3e} (reported); "
              f"launches {out[mode]['counts']}", flush=True)
    return out


def mode_export(dev):
    """The mxu model exported on the card for ("cuda", "cpu") at 64x128, 2
    iterations, saved, loaded, and run on both devices, each within
    EXPORT_ATOL of eager on that device."""
    import torch
    from prior_flow_tpu_torch import build_model, serving
    out_dir = os.path.join(REPO, "build", "phase23")
    os.makedirs(out_dir, exist_ok=True)
    h, w = EXPORT_HW
    model = build_model(seed=0, precision="highest", lookup_mode="mxu")
    state = model.state_dict()
    t0 = time.perf_counter()
    exported = serving.export_forward(model, state, (1, h, w), EXPORT_ITERS,
                                      platforms=["cuda", "cpu"])
    path = os.path.join(out_dir, "mxu.pt2")
    serving.save_exported(exported, path)
    fn = serving.load_exported(path)
    summary = serving.exported_summary(fn.exported)
    if summary["platforms"] != ["cpu", "cuda"]:
        fail(f"phase 23 export: platforms {summary['platforms']}")
    i1, i2 = images(24, h, w)
    out = dict(export_s=time.perf_counter() - t0)
    cpu_model = build_model("cpu", seed=0, precision="highest",
                            lookup_mode="mxu")
    for d, m in ((dev, model), (torch.device("cpu"), cpu_model)):
        st = {k: v.to(d) for k, v in state.items()}
        got = fn(st, i1.to(d), i2.to(d))
        want = serving.make_forward(m, EXPORT_ITERS)(st, i1.to(d), i2.to(d))
        err = (got - want).abs().max().item()
        out[f"err_{d.type}"] = err
        if not (got.device.type == d.type and err <= EXPORT_ATOL):
            fail(f"phase 23 export on {d.type}: {err:.3e} from eager (gate "
                 f"{EXPORT_ATOL})")
    print(f"  mxu program exported on the card for {summary['platforms']} "
          f"({h}x{w}, {EXPORT_ITERS} iterations): against eager, cuda "
          f"{out['err_cuda']:.3e}, cpu {out['err_cpu']:.3e} (gate "
          f"{EXPORT_ATOL}); export, save and load {out['export_s']:.1f} s",
          flush=True)
    return out


def phase_lookup_modes(dev, grids):
    """Phase 23: ``lookup_mode`` mxu and gather."""
    return dict(fields=mode_fields(dev, grids), forward=mode_forwards(dev),
                export=mode_export(dev))


# -- phase 24: deferred volume gradients, the legacy RAFT, batch statistics -----

DEFERRED_STEPS = TRAIN_STEPS   # timed after one warm-up, as phase 9
# (a) the deferred step's gradients against the taped step's (both turn
# the same field cotangents into volume cotangents with one stacked scatter
# per level and volume; bitwise on the CPU): each tensor, from the nearest
# of DEFERRED_TAPED taped steps, within this multiple of the largest
# distance between two of them (the scatter's f32 atomics) plus
# DEFERRED_RTOL of its norm (floored as grad_floor); against the standard
# step, phase 9's MODE_GRAD_RTOL (the standard step sums 12 per-iteration
# bf16 volume cotangents). One pair of taped steps is too few: the
# distance of two runs is spread widely for some tensors (fnet.conv2.weight:
# 0.5e-7 to 3.2e-7 on an H100), and against a single pair the deferred
# step failed 2 of 8 repeats of an unchanged tree
DEFERRED_TAPED = 4             # phase 9's taped step and three more
DEFERRED_SPREAD_X = 2.0
DEFERRED_RTOL = 1e-5
RAFT_H, RAFT_W = 440, 1024     # (b): a Sintel frame (436x1024) padded to /8
RAFT_TOL = 1e-4                # (b): card vs CPU, fp32, x max|flow|
RAFT_SUMS = {False: 15, True: 21}   # the fnet's instance norms per forward
BN_H, BN_W, BN_ITERS = 64, 128, 4   # (c)
BN_STATS_RTOL = 1e-4           # (c): each statistic, of its max|value|


def deferred_eft(dev, train):
    """(a) The EFT recipe with ``deferred_vol_grad=True``, standard grad
    mode, on phase 9's seeded weights and batches: launches per step,
    median ms/step and peak GB; the first step's loss against phase 9's
    standard step, its gradients against the nearest of phase 9's taped
    step and DEFERRED_TAPED - 1 more (within DEFERRED_SPREAD_X times the
    largest distance between two of them plus DEFERRED_RTOL of each norm)
    and against phase 9's standard step (MODE_GRAD_RTOL), the distance of
    a second standard step reported."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    batches = [train_batch(10 + i, TRAIN_B, H, W, dev)
               for i in range(DEFERRED_STEPS + 1)]
    want = forward_counts(dccl_level_lookup=LEVELS * ITERS,
                          instance_norm_sums=30,
                          dccl_level_scatter_grid=2 * LEVELS)
    again = {"standard": [], "taped": []}
    for mode in ("standard",) + ("taped",) * (DEFERRED_TAPED - 1):
        model, step = make_trainer(dev, mode, True, ITERS)
        step(batches[0], 0)
        again[mode].append(grads_of(model))
        del model, step
        torch.cuda.empty_cache()
    model, step = make_trainer(dev, "standard", True, ITERS,
                               deferred_vol_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, first = [], None
    for i, batch in enumerate(batches):
        reset_launch_counts()
        t0 = time.perf_counter()
        m = step(batch, i)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        if counts != want:
            fail(f"deferred step {i}: launch counts {counts}, expected "
                 f"{want}")
        loss = float(m["train/loss"])
        if not math.isfinite(loss):
            fail(f"deferred step {i}: loss {loss}")
        if i == 0:
            first = (loss, grads_of(model))
        else:
            times.append(dt)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, step
    torch.cuda.empty_cache()

    loss, g = first
    l_std, g_std = train["standard_first"]
    l_tap, g_tap = train["taped_first"]
    if abs(loss - l_std) > STEP_LOSS_RTOL * abs(l_std):
        fail(f"deferred loss {loss} vs standard {l_std}")
    total = math.sqrt(sum(float((a.double() ** 2).sum())
                          for a in g_std.values()))
    worst = {"taped": (0.0, ""), "standard": (0.0, "")}
    ratio_std = 0.0
    taped = [g_tap] + again["taped"]
    for n, ref in g_tap.items():
        d = min((g[n] - t[n]).norm().item() for t in taped)
        spread = max((a[n] - b[n]).norm().item()
                     for i, a in enumerate(taped) for b in taped[i + 1:])
        gate = (DEFERRED_SPREAD_X * spread + DEFERRED_RTOL
                * max(ref.norm().item(), grad_floor(n, total)))
        if d > gate:
            fail(f"deferred gradient {n} {d:.3e} from the nearest of "
                 f"{len(taped)} taped steps, gate {gate:.3e} (the taped "
                 f"steps at most {spread:.3e} apart)")
        worst["taped"] = max(worst["taped"], (d / gate, n))
        s = g_std[n]
        rel = ((g[n] - s).norm()
               / max(s.norm().item(), grad_floor(n, total))).item()
        if rel > MODE_GRAD_RTOL:
            fail(f"deferred and standard gradients differ on {n}: "
                 f"{rel:.3e}")
        worst["standard"] = max(worst["standard"], (rel, n))
        s_spread = (again["standard"][0][n] - s).norm().item()
        if s_spread > 0:
            ratio_std = max(ratio_std, (g[n] - s).norm().item() / s_spread)
    med = statistics.median(times)
    print(f"  (a) deferred {H}x{W} batch {TRAIN_B} iters {ITERS} bf16: "
          f"launches/step {counts}; median {med:.1f} ms/step over "
          f"{len(times)} after one warm-up (min {min(times):.1f}, max "
          f"{max(times):.1f}); peak {peak:.2f} GB; phase 9: standard "
          f"{train['standard']['ms']:.1f} ms {train['standard']['peak_gb']:.2f}"
          f" GB, taped {train['taped']['ms']:.1f} ms "
          f"{train['taped']['peak_gb']:.2f} GB", flush=True)
    print(f"  (a) first step: loss {loss:.6f} vs standard {l_std:.6f}, "
          f"taped {l_tap:.6f}; gradients: worst tensor at "
          f"{worst['taped'][0]:.3f} of its gate against the nearest of "
          f"{len(taped)} taped steps "
          f"({worst['taped'][1]}); against the standard step worst rel L2 "
          f"{worst['standard'][0]:.3e} ({worst['standard'][1]}, gate "
          f"{MODE_GRAD_RTOL}), at most {ratio_std:.1f}x the distance of two "
          f"standard steps", flush=True)
    return dict(ms=med, peak_gb=peak, counts=counts, loss=loss,
                loss_standard=l_std, worst_of_gate_vs_taped=worst["taped"][0],
                worst_rel_vs_standard=worst["standard"][0],
                max_x_standard_spread=ratio_std)


def deferred_card_vs_cpu(dev):
    """(a) One deferred step, fp32 ``precision="highest"``, 128x256, batch
    1, 2 iterations, on the card against the port's CPU deferred step
    (phase 10's gates)."""
    import torch
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    res = []
    for d in (torch.device("cpu"), dev):
        model, step = make_trainer(d, "standard", False, 2, seed=3,
                                   deferred_vol_grad=True,
                                   precision="highest")
        reset_launch_counts()
        m = step(train_batch(5, 1, 128, 256, d), 0)
        torch.cuda.synchronize()
        counts = launch_counts()
        res.append((float(m["train/loss"]),
                    {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters()}))
    want = forward_counts(dccl_level_lookup=2 * LEVELS, instance_norm_sums=30,
                          dccl_level_scatter_grid=2 * LEVELS)
    if counts != want:
        fail(f"deferred fp32 step: launch counts {counts}, expected {want}")
    (l_c, g_c), (l_g, g_g) = res
    if abs(l_g - l_c) > STEP_LOSS_RTOL * abs(l_c):
        fail(f"deferred fp32 step: card loss {l_g} vs CPU {l_c}")
    total = math.sqrt(sum(float((t.double() ** 2).sum())
                          for t in g_c.values()))
    worst = (0.0, "")
    for n, ref in g_c.items():
        rel = ((g_g[n] - ref).norm()
               / max(ref.norm().item(), grad_floor(n, total))).item()
        if rel > CARD_CPU_GRAD_RTOL:
            fail(f"deferred fp32 step: card and CPU gradients differ on {n}: "
                 f"{rel:.3e}")
        worst = max(worst, (rel, n))
    print(f"  (a) deferred 128x256 iters 2 fp32 highest: loss card {l_g:.6f} "
          f"CPU {l_c:.6f}; worst gradient rel L2 {worst[0]:.3e} ({worst[1]};"
          f" gate {CARD_CPU_GRAD_RTOL})", flush=True)
    return worst[0]


def raft_forwards(dev):
    """(b) ``RAFT`` basic and small at their published widths, a 440x1024
    pair, batch 1, 12 iterations: fp32 ``precision="highest"`` on the card
    against the port's CPU within RAFT_TOL x max|flow|; the sums' launches
    per forward (the only kernel on this path) and nothing else; fp32 and
    bf16 ms/pair (median of 7 after a warm-up)."""
    import torch
    from prior_flow_tpu_torch.models import build_raft
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    c1, c2 = images(24, RAFT_H, RAFT_W)
    g1, g2 = c1.to(dev), c2.to(dev)
    out = {}
    for small in (False, True):
        tag = "small" if small else "basic"
        t0 = time.perf_counter()
        ref = build_raft("cpu", seed=0, small=small, precision="highest")(
            c1, c2, iters=ITERS)
        cpu_s = time.perf_counter() - t0
        model = build_raft(dev, seed=0, small=small, precision="highest")
        reset_launch_counts()
        flow = model(g1, g2, iters=ITERS)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = forward_counts(instance_norm_sums=RAFT_SUMS[small])
        if counts != want:
            fail(f"RAFT {tag}: launch counts {counts}, expected {want}")
        err = (flow.cpu() - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not (torch.isfinite(flow).all() and err <= RAFT_TOL * scale):
            fail(f"RAFT {tag}: card and CPU differ by {err:.3e}, flow scale "
                 f"{scale:.3f}")
        ms32 = pair_ms(lambda: model(g1, g2, iters=ITERS))
        model16 = build_raft(dev, seed=0, small=small, mixed_precision=True)
        flow16 = model16(g1, g2, iters=ITERS)
        if not torch.isfinite(flow16).all():
            fail(f"RAFT {tag} bf16: flow not finite")
        ms16 = pair_ms(lambda: model16(g1, g2, iters=ITERS))
        out[tag] = dict(ratio=err / scale, scale=scale, ms_fp32=ms32,
                        ms_bf16=ms16, counts=counts, cpu_s=cpu_s,
                        bf16_vs_fp32=(flow16 - flow).abs().max().item() / scale)
        print(f"  (b) RAFT {tag} {RAFT_H}x{RAFT_W} iters {ITERS}: card vs CPU "
              f"fp32 max err {err:.3e}, flow scale {scale:.3f}, ratio "
              f"{err / scale:.3e} (gate {RAFT_TOL}); {ms32:.1f} ms/pair fp32, "
              f"{ms16:.1f} bf16 (bf16 vs fp32 {out[tag]['bf16_vs_fp32']:.3e} "
              f"x scale, reported); launches {counts}; CPU forward "
              f"{cpu_s:.1f} s", flush=True)
        del model, model16
        torch.cuda.empty_cache()
    return out


def bn_batch_statistics(dev):
    """(c) ``bn_running_average=False`` (PriOrRAFT, and the basic RAFT),
    a 64x128 test-mode forward, 4 iterations, fp32 ``precision=
    "highest"``: flow card vs CPU (CARD_CPU_TOL x flow scale) and the
    context encoder's updated running statistics (BN_STATS_RTOL of each
    tensor's max|value|)."""
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.models import build_raft
    c1, c2 = images(25, BN_H, BN_W)
    out = {}
    for tag, build in (("prior_raft", build_model), ("raft", build_raft)):
        res = []
        for d in (torch.device("cpu"), dev):
            model = build(d, seed=1, precision="highest",
                          bn_running_average=False)
            flow = model(c1.to(d), c2.to(d), iters=BN_ITERS).cpu()
            res.append((flow, {k: v.cpu() for k, v in
                               model.cnet.state_dict().items()
                               if k.endswith(("running_mean",
                                              "running_var"))}))
        (f_c, s_c), (f_g, s_g) = res
        scale = f_c.abs().max().item()
        err = (f_g - f_c).abs().max().item()
        if not err <= CARD_CPU_TOL * scale:
            fail(f"bn_running_average=False {tag}: card and CPU flows differ "
                 f"by {err:.3e} (scale {scale:.3f})")
        worst = 0.0
        for k, ref in s_c.items():
            rel = ((s_g[k] - ref).abs().max() / ref.abs().max()).item()
            if rel > BN_STATS_RTOL:
                fail(f"bn_running_average=False {tag}: statistic {k} "
                     f"{rel:.3e} from the CPU's")
            worst = max(worst, rel)
        out[tag] = dict(flow_ratio=err / scale, stats_rel=worst,
                        n_stats=len(s_c))
        print(f"  (c) bn_running_average=False {tag} {BN_H}x{BN_W}: flow "
              f"card vs CPU {err / scale:.3e} x scale (gate {CARD_CPU_TOL}); "
              f"{len(s_c)} running statistics, worst {worst:.3e} of max "
              f"(gate {BN_STATS_RTOL})", flush=True)
    return out


def phase_deferred_raft(dev, train):
    """Phase 24: (a) deferred volume gradients, (b) the legacy RAFT, (c)
    batch-statistics BatchNorm."""
    t0 = time.perf_counter()
    out = dict(deferred=deferred_eft(dev, train))
    out["deferred"]["card_vs_cpu_worst"] = deferred_card_vs_cpu(dev)
    t1 = time.perf_counter()
    out["raft"] = raft_forwards(dev)
    t2 = time.perf_counter()
    out["bn"] = bn_batch_statistics(dev)
    out["s"] = time.perf_counter() - t0
    print(f"  phase 24: {out['s']:.1f} s ((a) {t1 - t0:.1f} s, (b) "
          f"{t2 - t1:.1f} s, (c) {out['s'] - (t2 - t0):.1f} s)", flush=True)
    return out


# -- phase 25: the space axis (height sharding) ----------------------------------

SP_SHAPE = (1, 2)         # (a), (b), (d): one data rank of two height slices
SP_B = 2                  # (a), (d): the global batch per data rank
SP_STEPS = 2              # (a): updates per rank of the standard step; the
                          #      first is gated, the second timed
SP_MODE_STEPS = 1         # (a): updates per rank of the taped and deferred
                          #      steps (gated, not timed)
SP_SHORT = 1              # (a): the iterations of the step gated strictly
SP_FLOW_SHORT = 3         # (b): the iterations of the forward gated strictly
SP_GRAD_RTOL = 1e-5       # (a): per tensor, of its norm (or SP_SPREAD_X x
SP_SPREAD_X = 2.0         #      the distance of two one-process steps)
SP_LOSS_RTOL = 1e-5
SP_PARAM_ATOL = 1e-5      # (a): JAX's
SP_FLOW_TOL = 1e-4        # (b): x flow scale, JAX's
SP_ULP = 2.0 ** -23       # the sensitivity references' relative image change
SP_RUNS = 2               # (b): forwards per rank and job, the first counted
SP_SUMS_RTOL = 1e-9       # the sums kernel's f64 partial sums, of max|plain|
SP_TIMEOUT_S = 600.0
SP_RAFT_HW = (440, 1024)  # (d): RAFT's published pair, H / 8 = 55: strips
                          #      of 224 and 216 rows (the second padded)
SP_UNEVEN_HW = (520, 1040)  # (d): PriOr-RAFT at H / 8 = 65: 264 + 256 rows
SP_BN_HW = (64, 128)      # (d): the batch-statistics step, phase 24 (c)'s size


def space_sums_f64(dev, shapes):
    """The sums kernel's f64 output (the height-sharded norm's partial
    sums) against its plain version at ``shapes``: (x, x) f32 and bf16,
    (xhat, dy) f32."""
    import torch
    from prior_flow_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_sums, instance_norm_sums_plain)
    g = torch.Generator(device=dev).manual_seed(25)
    worst = 0.0
    for shape in shapes:
        x = torch.randn(shape, generator=g, device=dev) * 3 + 1
        dy = torch.randn(shape, generator=g, device=dev)
        for a, b in ((x, x), (x.bfloat16(), x.bfloat16()), (x, dy)):
            got = instance_norm_sums(a, b, torch.float64)
            want = instance_norm_sums_plain(a, b, torch.float64)
            for u, v in zip(got, want):
                if u.dtype != torch.float64:
                    fail(f"phase 25: f64 sums came back {u.dtype}")
                err = ((u - v).abs().max() / v.abs().max()).item()
                worst = max(worst, err)
    if worst > SP_SUMS_RTOL:
        fail(f"phase 25: the sums kernel's f64 output lies {worst:.3e} of "
             f"max|plain| from its plain version (gate {SP_SUMS_RTOL})")
    print(f"  the sums kernel's f64 output (x, x) f32 / bf16 and (xhat, dy) "
          f"at {shapes}: worst {worst:.3e} of max|plain| (gate "
          f"{SP_SUMS_RTOL})", flush=True)
    return worst


def nudged(images, sign: int):
    """The pair (and the rest of a batch) with both images scaled by
    1 + sign * SP_ULP: about one f32 rounding of each pixel."""
    return (images[0] * (1 + sign * SP_ULP), images[1] * (1 + sign * SP_ULP),
            *images[2:])


def _global_rel(g, ref) -> float:
    num = sum(float(((g[k] - r).double() ** 2).sum()) for k, r in ref.items())
    den = sum(float((r.double() ** 2).sum()) for r in ref.values())
    return math.sqrt(num / den)


# one-process step references by (batch key, case): phase 22 (b) and
# phase 25 (d) hold the batch-statistics step on the same batch
_STEP_REFS = {}


def space_step_refs(dev, batch, cases, kw, key=None):
    """(a)'s references in this process, per case: the one-process step,
    again, and on the images nudged by one rounding either way: the
    step's sensitivity to f32 rounding. With a ``key`` naming the batch,
    a case's references are computed once per run of the script."""
    import torch
    from prior_flow_tpu_torch.parallel.dryrun import train_once
    refs = []
    for case in cases:
        memo = None if key is None else (key, json.dumps(
            {k: v for k, v in case.items() if k != "gate"}, sort_keys=True))
        if memo in _STEP_REFS:
            refs.append(_STEP_REFS[memo])
            continue
        runs = [train_once(None, dev, case, batch, **kw) for _ in range(2)]
        runs += [train_once(None, dev, case, nudged(batch, s), **kw)
                 for s in (1, -1)]
        if memo is not None:
            _STEP_REFS[memo] = runs
        refs.append(runs)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return refs


def space_step_cases():
    """(a)'s cases: the standard, taped and deferred steps at the EFT
    recipe, each at 12 iterations and at SP_SHORT."""
    cases = []
    for mode in ("standard", "taped", "deferred"):
        for it in (ITERS, SP_SHORT):
            case = dict(mode=mode, iters=it, hw=(H, W),
                        grad_mode="taped" if mode == "taped" else "standard")
            if mode == "deferred":
                case["model"] = dict(deferred_vol_grad=True)
            if mode != "standard":
                case["steps"] = SP_MODE_STEPS
            cases.append(case)
    return cases


def step_launches(case) -> dict:
    """A step's launches per rank: kernel 1 four per iteration (the
    deferred step's in its recording pass), the 30 sums, and two grid
    scatters per level and iteration (standard) or per level (taped,
    deferred: one stacked scatter per volume); on the planes route
    (``case["planes"]``: 1/8 grids wider than 128 columns) one coords
    launch and the lookup at given coords per level and iteration, and
    two given-coords scatters per level and iteration."""
    it = case["iters"]
    if case.get("planes"):
        return {"dccl_level_lookup_coords": LEVELS * it,
                "dccl_cross_coords": it, "instance_norm_sums": 30,
                "dccl_level_scatter": 2 * LEVELS * it}
    stacked = (case["grad_mode"] == "taped"
               or case.get("model", {}).get("deferred_vol_grad", False))
    return {"dccl_level_lookup": LEVELS * it, "instance_norm_sums": 30,
            "dccl_level_scatter_grid": 2 * LEVELS * (1 if stacked else it)}


def space_step_gates(ranks, refs, cases, shape, tag: str,
                     part: str = "(a)", batch: int = 0) -> dict:
    """The steps' gates per case: launches per rank; every rank's
    gradients, parameters and buffers bitwise rank 0's; the loss, the
    updated parameters and the buffers (the batch-statistics BatchNorm's
    running statistics) against the one-process step of the same mode;
    each gradient tensor within SP_GRAD_RTOL of its norm, or SP_SPREAD_X
    times the largest distance of the one-process step from itself (the
    scatter's atomics) and from the steps on nudged images. The split
    rounds each convolution's sums in another order, and a ReLU whose
    input lies within that rounding of zero then passes or stops its
    cotangent (found at 64x128 on the CPU: two such ReLUs put the split
    step 4.03e-4 of the gradients' norm from one process's); the
    recurrence spreads such differences, as it spreads the nudged
    images'. A norm is floored as phase 9 floors it (``grad_floor``: the
    fnet conv biases in front of an instance norm carry only
    round-off). A case with ``gate="global"`` holds the distance over
    all tensors instead (within SP_GRAD_RTOL of the global norm, or
    SP_SPREAD_X times the largest of the same distances): two nudged
    steps are too few to bound each tensor's spread at 12 iterations
    (the batch-statistics step at 64x128 lay 1.06 of such a gate on one
    tensor on the card, and 1.44e-5 of the global norm against nudged
    8.5e-5 on the CPU)."""
    out = {}
    for i, case in enumerate(cases):
        it, mode, (h, w) = case["iters"], case["mode"], case["hw"]
        what = f"{tag} {part} {mode} {h}x{w} {it} iterations"
        want = step_launches(case)
        for r, res in enumerate(ranks):
            if not (res[i]["grads_same"] and res[i]["params_same"]
                    and res[i]["buffers_same"]):
                fail(f"{what}: rank {r}'s gradients, parameters or buffers "
                     f"differ from rank 0's")
            if res[i]["launches"] != want:
                fail(f"{what} rank {r}: launches per step "
                     f"{res[i]['launches']}, expected {want}")
        got, (ref, again, *nudges) = ranks[0][i], refs[i]
        l1, l0 = got["metrics"]["train/loss"], ref["metrics"]["train/loss"]
        if abs(l1 - l0) > SP_LOSS_RTOL * abs(l0):
            fail(f"{what}: loss {l1} against the one-process step's {l0}")
        worst = (0.0, "")
        total = _flat(ref["grads"].values()).norm().item()
        for k, r in ref["grads"].items():
            d = (got["grads"][k] - r).norm().item()
            spread = max([(again["grads"][k] - r).norm().item()]
                         + [(n["grads"][k] - r).norm().item()
                            for n in nudges])
            gate = max(SP_GRAD_RTOL * max(r.norm().item(),
                                          grad_floor(k, total)),
                       SP_SPREAD_X * spread)
            if d > gate and case.get("gate") != "global":
                fail(f"{what}: gradient {k} {d:.3e} from the one-process "
                     f"step's, gate {gate:.3e}")
            if gate > 0:
                worst = max(worst, (d / gate, k))
        dp = max((got["params"][k] - p).abs().max().item()
                 for k, p in ref["params"].items())
        if dp > SP_PARAM_ATOL:
            fail(f"{what}: updated parameters {dp:.3e} from the one-process "
                 f"step's (atol {SP_PARAM_ATOL})")
        db = max([(got["buffers"][k] - b).abs().max().item()
                  / max(b.abs().max().item(), 1e-30)
                  for k, b in ref["buffers"].items()] or [0.0])
        if db > BN_STATS_RTOL:
            fail(f"{what}: buffers {db:.3e} of their max|value| from the "
                 f"one-process step's (gate {BN_STATS_RTOL})")
        rel = dict(sharded=_global_rel(got["grads"], ref["grads"]),
                   two_runs=_global_rel(again["grads"], ref["grads"]),
                   nudged=[_global_rel(n["grads"], ref["grads"])
                           for n in nudges])
        if case.get("gate") == "global":
            g_gate = max(SP_GRAD_RTOL, SP_SPREAD_X * max(
                [rel["two_runs"], *rel["nudged"]]))
            if rel["sharded"] > g_gate:
                fail(f"{what}: gradients {rel['sharded']:.3e} of the "
                     f"global norm from the one-process step's, gate "
                     f"{g_gate:.3e}")
            worst = (rel["sharded"] / g_gate, "all tensors")
        per_rank = [dict(ms=statistics.median(res[i]["ms"])
                         if res[i]["ms"] else None,
                         peak_gb=res[i]["peak_gb"]) for res in ranks]
        peaks = "; ".join(
            f"rank {r}: " + (f"{q['ms']:.1f} ms/step, " if q["ms"] else "")
            + f"peak {q['peak_gb']} GB" for r, q in enumerate(per_rank))
        peaks += f" (one process: peak {ref['peak_gb']} GB)"
        print(f"  {part} {shape[0]}x{shape[1]} mesh, the {mode} step at "
              f"{h}x{w}, global batch {batch or SP_B * shape[0]}, {it} "
              f"iterations, "
              f"fp32, remat dccl: loss {l1:.6f} vs {l0:.6f}; gradients "
              f"{rel['sharded']:.3e} of the global norm from one process's "
              f"(two one-process steps {rel['two_runs']:.3e}, nudged images "
              f"{rel['nudged'][0]:.3e} / {rel['nudged'][1]:.3e}); worst "
              f"tensor at {worst[0]:.3f} of its gate ({worst[1]}); "
              f"parameters {dp:.3e} apart, buffers {db:.3e}; per rank "
              f"{peaks}; launches per step and rank {got['launches']}",
              flush=True)
        out[f"{mode}_{it}"] = dict(
            loss=l1, loss_ref=l0, worst_of_gate=worst[0],
            worst_tensor=worst[1], param_dist=dp, buffer_rel=db,
            grad_rel=rel, ranks=per_rank, peak_gb_ref=ref["peak_gb"],
            launches=got["launches"])
    return out


def space_forward_refs(dev, pair, iters, kw):
    """(b)'s references in this process: the one-process forward at each
    of ``iters``, its peak GB at the last, and at the last the forwards on
    the nudged pair (the sensitivity)."""
    import torch
    from prior_flow_tpu_torch import build_model
    cuda = dev.type == "cuda"
    model = build_model(dev, seed=0, **kw)
    run = lambda p, it: model(*(t.to(dev) for t in p), iters=it).cpu()
    flows = {it: run(pair, it) for it in iters[:-1]}
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    flows[iters[-1]] = run(pair, iters[-1])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else math.nan
    nudges = [run(nudged(pair, s), iters[-1]) for s in (1, -1)]
    del model
    if cuda:
        torch.cuda.empty_cache()
    return flows, nudges, peak


def space_forward_gates(ranks, refs, iters, shape, size, tag: str) -> dict:
    """(b)'s gates: launches per rank (at 1024x2048 the planes route: rows
    3 and 5 and the sums) and the ranks' rows against the one-process
    flow: within SP_FLOW_TOL x flow scale at SP_FLOW_SHORT iterations;
    at 12 within the larger of that and SP_SPREAD_X times the distance
    the nudged pair puts the one-process flow from itself."""
    import torch
    flows, nudges, ref_peak = refs
    D, S = shape
    out = {}
    for j, it in enumerate(iters):
        want = {k: v for k, v in forward_counts(
            dccl_level_lookup_coords=LEVELS * it,
            dccl_cross_coords=it).items() if v}
        for r, res in enumerate(ranks):
            if res[j]["launches"] != want:
                fail(f"{tag} (b) {it} iterations rank {r}: launches per "
                     f"forward {res[j]['launches']}, expected {want}")
        flow = torch.cat([torch.cat([ranks[d * S + s][j]["flow"]
                                     for s in range(S)], dim=1)
                          for d in range(D)])
        ref = flows[it]
        scale = ref.abs().max().item()
        err = (flow - ref).abs().max().item() / scale
        sens = ([(n - ref).abs().max().item() / scale for n in nudges]
                if it == iters[-1] else [])
        gate = max([SP_FLOW_TOL] + [SP_SPREAD_X * v for v in sens])
        if not (torch.isfinite(flow).all() and err <= gate):
            fail(f"{tag} (b) {it} iterations: the sharded forward lies "
                 f"{err:.3e} x flow scale from the one-process flow (gate "
                 f"{gate:.3e}; nudged pair {sens})")
        per_rank = [dict(ms=statistics.median(res[j]["ms"])
                         if res[j]["ms"] else None,
                         peak_gb=res[j]["peak_gb"]) for res in ranks]
        print(f"  (b) {D}x{S} mesh, the {size[0]}x{size[1]} fp32 test-mode "
              f"forward, {it} iterations: {err:.3e} x flow scale "
              f"{scale:.3f} from the one-process flow (gate {gate:.3e}"
              + (f"; the nudged pair puts one process {sens[0]:.3e} / "
                 f"{sens[1]:.3e} from itself" if sens else "")
              + f"); peak GB per rank {[q['peak_gb'] for q in per_rank]}"
              + (f" beside one process's {ref_peak:.3f}"
                 if it == iters[-1] else "")
              + f"; ms/pair per rank {[q['ms'] for q in per_rank]}; "
              f"launches per forward and rank {ranks[0][j]['launches']}; "
              f"route {ranks[0][j]['route']}", flush=True)
        out[it] = dict(err_ratio=err, gate=gate, nudged=sens,
                       ranks=per_rank, launches=ranks[0][j]["launches"])
    out["peak_gb_ref"] = ref_peak
    out["route"] = ranks[0][0]["route"]
    return out


def space_modes_inputs(shape):
    """(d)'s inputs, one pair (or two batch rows) per data rank: the
    forwards (name, ``build_model`` / ``build_raft`` keywords, RAFT?,
    pair, iterations): ``mxu`` and ``gather`` at H x W, SP_FLOW_SHORT
    iterations, RAFT basic and small at SP_RAFT_HW, 12, PriOr-RAFT at
    SP_UNEVEN_HW, SP_FLOW_SHORT; the batch-statistics step at SP_BN_HW
    (its batch and cases: SP_SHORT iterations gated per tensor as (a)'s,
    12 on the global distance); and the standard step at SP_UNEVEN_HW
    (its batch and case: SP_SHORT iterations, per tensor)."""
    import torch
    from prior_flow_tpu_torch.parallel import dryrun
    D = shape[0]
    pair_of = lambda seed, h, w: tuple(torch.cat(
        [images(seed + d, h, w)[i] for d in range(D)]) for i in (0, 1))
    pair, raft_pair = pair_of(5, H, W), pair_of(7, *SP_RAFT_HW)
    forwards = [("mxu", dict(lookup_mode="mxu"), False, pair, SP_FLOW_SHORT),
                ("gather", dict(lookup_mode="gather"), False, pair,
                 SP_FLOW_SHORT),
                ("raft_basic", {}, True, raft_pair, ITERS),
                ("raft_small", dict(small=True), True, raft_pair, ITERS),
                ("uneven", {}, False, pair_of(9, *SP_UNEVEN_HW),
                 SP_FLOW_SHORT)]
    bn_cases = [dict(mode="batch-statistics", grad_mode="standard",
                     iters=it, hw=SP_BN_HW, steps=1,
                     model=dict(bn_running_average=False),
                     gate="global" if it == ITERS else "tensor")
                for it in (SP_SHORT, ITERS)]
    uneven_case = dict(mode="standard", grad_mode="standard", iters=SP_SHORT,
                       hw=SP_UNEVEN_HW, steps=1, planes=True)
    return (forwards, dryrun.synthetic_batch(13, SP_B * D, *SP_BN_HW),
            bn_cases, dryrun.synthetic_batch(17, SP_B * D, *SP_UNEVEN_HW),
            [uneven_case])


def space_modes_refs(dev, modes, kw):
    """(d)'s references in this process: each forward and its peak GB, at
    12 iterations also on the nudged pair; the steps as (a)'s
    (``space_step_refs``)."""
    import torch
    from prior_flow_tpu_torch.models import build_model, build_raft
    forwards, bn_batch, bn_cases, uneven_batch, uneven_cases = modes
    cuda = dev.type == "cuda"
    flows = {}
    for name, mkw, raft, pair, it in forwards:
        model = (build_raft if raft else build_model)(dev, seed=0, **kw,
                                                      **mkw)
        run = lambda p: model(*(t.to(dev) for t in p), iters=it).cpu()
        if cuda:   # the forward's own peak, above what this process held
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        flow = run(pair)
        peak = ((torch.cuda.max_memory_allocated(dev) - base) / 1e9 if cuda
                else None)
        flows[name] = (flow, [run(nudged(pair, s)) for s in (1, -1)]
                       if it == ITERS else [], peak)
        del model
    if cuda:
        torch.cuda.empty_cache()
    return (flows, space_step_refs(dev, bn_batch, bn_cases, kw,
                                   key=("bn", 13, bn_batch[0].shape[0])),
            space_step_refs(dev, uneven_batch, uneven_cases, kw))


def space_modes_gates(ranks, refs, modes, shape, tag: str) -> dict:
    """(d)'s gates: each forward's launches per rank (the sums only: 15,
    RAFT small 21; no lookup kernel; PriOr-RAFT at SP_UNEVEN_HW the
    planes route, rows 3 and 5 too) and the ranks' rows within
    SP_FLOW_TOL x flow scale of the one-process flow (at 12 iterations
    within the larger of that and SP_SPREAD_X times the distance the
    nudged pair puts the one-process flow from itself), each rank's peak
    GB beside one process's; the batch-statistics step and the step at
    SP_UNEVEN_HW as (a)'s."""
    import torch
    forwards, _, bn_cases, _, uneven_cases = modes
    flows, step_refs, uneven_refs = refs
    D, S = shape
    out = {}
    for j, (name, mkw, raft, pair, it) in enumerate(forwards):
        if raft:
            want = {"instance_norm_sums": RAFT_SUMS[bool(mkw.get("small"))]}
        elif "lookup_mode" in mkw:
            want = {"instance_norm_sums": 15}
        else:
            want = {k: v for k, v in forward_counts(
                dccl_level_lookup_coords=LEVELS * it,
                dccl_cross_coords=it).items() if v}
        for r, res in enumerate(ranks):
            if res[j][0]["launches"] != want:
                fail(f"{tag} (d) {name} rank {r}: launches per forward "
                     f"{res[j][0]['launches']}, expected {want}")
        flow = torch.cat([torch.cat([ranks[d * S + s][j][0]["flow"]
                                     for s in range(S)], dim=1)
                          for d in range(D)])
        ref, nudges, ref_peak = flows[name]
        scale = ref.abs().max().item()
        err = (flow - ref).abs().max().item() / scale
        peaks = [res[j][0]["peak_gb"] for res in ranks]
        sens = [(n - ref).abs().max().item() / scale for n in nudges]
        gate = max([SP_FLOW_TOL] + [SP_SPREAD_X * v for v in sens])
        if not (torch.isfinite(flow).all() and err <= gate):
            fail(f"{tag} (d) {name} {it} iterations: the sharded forward "
                 f"lies {err:.3e} x flow scale from the one-process flow "
                 f"(gate {gate:.3e}; nudged pair {sens})")
        h, w = pair[0].shape[1:3]
        print(f"  (d) {D}x{S} mesh, {name} fp32 test-mode forward at "
              f"{h}x{w}, {it} iterations: {err:.3e} x flow scale "
              f"{scale:.3f} from the one-process flow (gate {gate:.3e}"
              + (f"; the nudged pair puts one process {sens[0]:.3e} / "
                 f"{sens[1]:.3e} from itself" if sens else "")
              + f"); peak GB per rank {peaks} (each rank's process) "
              f"beside one process's {ref_peak} (above what it held "
              f"before the forward); launches per forward and rank "
              f"{ranks[0][j][0]['launches']}", flush=True)
        out[name] = dict(err_ratio=err, gate=gate, nudged=sens,
                         peak_gb=peaks, peak_gb_ref=ref_peak,
                         launches=ranks[0][j][0]["launches"])
    out["step"] = space_step_gates([res[len(forwards)] for res in ranks],
                                   step_refs, bn_cases, shape, tag, "(d)")
    out["uneven_step"] = space_step_gates(
        [res[len(forwards) + 1] for res in ranks], uneven_refs,
        uneven_cases, shape, tag, "(d)")
    return out


def space_runs(dev, shape, device: str, backend: str, tag: str,
               with_dryrun: int = 0) -> dict:
    """(a), (b) and (d) on a ``shape`` data x space mesh of spawned ranks
    (``device`` / ``backend`` as ``parallel.dryrun.spawn`` reads them),
    and with ``with_dryrun`` > 0 ``dryrun_multichip(with_dryrun)``, after
    this process's references: (a) beside (b) then (d) beside the
    dryrun. (a) the standard, taped and deferred steps at 12 iterations
    and at SP_SHORT, a global batch of SP_B per data rank; (b) at
    SP_FLOW_SHORT and 12, one pair per data rank; (d) the lookup modes,
    RAFT and the batch-statistics step (``space_modes_inputs``)."""
    import concurrent.futures

    import torch
    from prior_flow_tpu_torch.parallel import dryrun
    n = shape[0] * shape[1]
    kw = dict(precision="highest")
    cases = space_step_cases()
    iters = (SP_FLOW_SHORT, ITERS)
    batch = dryrun.synthetic_batch(11, SP_B * shape[0], H, W)
    # (b): one pair per data rank
    pair = tuple(torch.cat([images(2 + d, H2, W2)[i]
                            for d in range(shape[0])]) for i in (0, 1))
    modes = space_modes_inputs(shape)
    t_refs = time.perf_counter()
    fwd_refs = space_forward_refs(dev, pair, iters, kw)
    step_refs = space_step_refs(dev, batch, cases, kw)
    mode_refs = space_modes_refs(dev, modes, kw)
    laps = {"references": time.perf_counter() - t_refs}
    mode_runs = [("forward_rows", ([(*p, it)], 0, 1, {**kw, **mkw}, raft))
                 for _, mkw, raft, p, it in modes[0]]
    mode_runs.append(("rank_updates", (modes[2], modes[1], 1, 0, kw)))
    mode_runs.append(("rank_updates", (modes[4], modes[3], 1, 0, kw)))
    t0 = time.perf_counter()

    def spawn(fn, *args):
        res = dryrun.spawn(fn, n, *args, device=device, backend=backend,
                           timeout_s=SP_TIMEOUT_S, shape=shape)
        laps[fn.__name__] = time.perf_counter() - t0
        return res

    def dry():
        t = time.perf_counter()
        res = dryrun.dryrun_multichip(with_dryrun, device=device,
                                      backend=backend)
        return dict(loss=res["loss"], s=time.perf_counter() - t)

    def forward_then_modes():
        # (b), then (d): beside (a), two pools of ranks on the card at once
        return (spawn(dryrun.forward_rows, [(*pair, it) for it in iters], 0,
                      SP_RUNS, kw),
                spawn(dryrun.rank_runs, mode_runs))

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        step = pool.submit(spawn, dryrun.rank_updates, cases, batch,
                           SP_STEPS, 0, kw)
        rest = pool.submit(forward_then_modes)
        dryrun_out = pool.submit(dry) if with_dryrun else None
        fwd, mode_ranks = rest.result()
        out = {"step": space_step_gates(step.result(), step_refs, cases,
                                        shape, tag),
               "forward": space_forward_gates(fwd, fwd_refs, iters, shape,
                                              (H2, W2), tag),
               "modes": space_modes_gates(mode_ranks, mode_refs, modes,
                                          shape, tag)}
        if dryrun_out is not None:
            out["dryrun"] = dryrun_out.result()
    out["spawned_s"] = time.perf_counter() - t0
    out["laps"] = laps
    print(f"  {tag}: this process's references {laps['references']:.1f} s; "
          f"then, from the spawns, (a) ended at "
          f"{laps['rank_updates']:.1f} s, (b) at {laps['forward_rows']:.1f} "
          f"s, (d) at {laps['rank_runs']:.1f} s", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_space(dev):
    """Phase 25: the space axis on the one card, ranks sharing it over
    gloo: the sums kernel's f64 output; (a) the EFT steps in three modes,
    (b) the 1024x2048 forward and (d) the lookup modes, RAFT and the
    batch-statistics step on a 1x2 mesh against one process; (c)
    ``dryrun_multichip(4)`` (a 2x2 mesh), side by side with them."""
    t0 = time.perf_counter()
    half = [(b, c, h // SP_SHAPE[1], w) for b, c, h, w in FNET_SHAPES_HR]
    out = {"sums_f64_rel": space_sums_f64(dev, half)}
    out.update(space_runs(dev, SP_SHAPE, "cuda:0", "gloo", "phase 25",
                          with_dryrun=4))
    out["s"] = time.perf_counter() - t0
    print(f"  phase 25: {out['s']:.1f} s ((a)-(d) side by side "
          f"{out['spawned_s']:.1f} s; two pools of two ranks share the card "
          f"with each other, (c)'s four and this process: no speed claim)",
          flush=True)
    return out


# -- --multichip: data parallel over the host's cards ----------------------------

MULTICHIP_TIMEOUT_S = 900


def multichip_cli(n: int, base: str):
    """``cli.train --mesh auto`` at the EFT recipe (phase 19's tree and
    flags: 512x1024, global batch 4, 12 iterations, bf16, 6 updates, a
    checkpoint and a rank-0 validation of 3 pairs after updates 3 and 6,
    noise), both ways a user starts it: in-process, where ``auto`` spawns
    one rank per card, and under ``torchrun --standalone
    --nproc_per_node=n``. Gates: the checkpoint tags, rank 0's log (two
    validations, finite values). Returns the wall seconds of each run,
    the ranks' start included."""
    import subprocess

    import numpy as np
    from prior_flow_tpu_torch.cli import train as cli
    tree = os.path.join(base, "mpf")
    rng = np.random.default_rng(19)
    write_mpf_scene(tree, "EFTs_Car2000", TRAIN_CLI_FRAMES, H, W, rng)
    write_mpf_scene(tree, "EFTs_Car100", TRAIN_CLI_VAL_PAIRS + 1, H, W, rng)
    common = ["--mesh", "auto", "--stage", "EFT", "--data_root", tree,
              "--batch_size", str(TRAIN_B), "--iters", str(ITERS),
              "--mixed_precision", "--num_steps", str(TRAIN_CLI_NUM_STEPS),
              "--val_freq", str(TRAIN_CLI_VAL_FREQ), "--validation", "EFT",
              "--add_noise"]
    out = {}
    for how in ("spawn", "torchrun"):
        save = os.path.join(base, f"ckpt_{how}")
        t0 = time.perf_counter()
        if how == "spawn":
            if cli.main(common + ["--save_path", save]) is not None:
                fail(f"--multichip cli.train --mesh auto on {n} cards ran "
                     f"in this process, not on {n} spawned ranks")
        else:
            env = dict(os.environ, PYTHONPATH=REPO)
            run = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", f"--nproc_per_node={n}", "-m",
                 "prior_flow_tpu_torch.cli.train", *common, "--save_path",
                 save], cwd=REPO, env=env, capture_output=True, text=True,
                timeout=MULTICHIP_TIMEOUT_S)
            if run.returncode != 0:
                fail(f"--multichip torchrun cli.train: exit "
                     f"{run.returncode}\n{run.stderr[-3000:]}")
        out[how] = time.perf_counter() - t0
        tags = sorted(os.listdir(save))
        records = jsonl(os.path.join(save, "logs", "EFT.jsonl"))
        val = [r for r in records if "EFT-epe" in r]
        logged = [v for r in records for k, v in r.items() if k != "ts"]
        if tags != TRAIN_CLI_TAGS or [r["step"] for r in val] != [2, 5] or \
                not all(math.isfinite(v) for v in logged):
            fail(f"--multichip cli.train ({how}): tags {tags}, log records "
                 f"{records}")
        loss = [r["train/loss"] for r in records if "train/loss" in r]
        print(f"  cli.train --mesh auto ({how}) on {n} cards, {H}x{W} batch "
              f"{TRAIN_B} iters {ITERS} bf16, {TRAIN_CLI_NUM_STEPS + 1} "
              f"updates, 2 rank-0 validations: tags {tags}; logged loss "
              f"{loss}; validation "
              f"{[(r['EFT-epe'], r['EFT-SEPE']) for r in val]}; "
              f"{out[how]:.1f} s wall, the ranks' start included",
              flush=True)
    return out


def multichip_main(name: str) -> None:
    """``--multichip``: the data-parallel path on every visible card, one
    rank per card over NCCL: phase 22 (b)'s gradient gates, then
    ``dryrun_multichip(n)`` (a 2 x n/2 data x space mesh where n is even
    and at least 4) and ``cli.train --mesh auto``; with four or more
    cards (an even count) phase 25 (a), (b) and (d) on a 2 x n/2 NCCL
    mesh."""
    import tempfile

    import torch
    from prior_flow_tpu_torch.ops.kernels import _build
    from prior_flow_tpu_torch.parallel import dryrun_multichip
    n = torch.cuda.device_count()
    if n < 2:
        fail(f"--multichip needs two or more cards, found {n}")
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {lib.build_seconds:.1f} s -> {lib.path.name}", flush=True)
    print(f"multichip (a) {n} NCCL ranks, one card each, against the shares "
          f"summed in one process", flush=True)
    out = {"ranks": dp_ranks(dev, n, device="cuda", backend="nccl",
                             tag="multichip (a)",
                             label=" (one card each)")}
    print(f"multichip (b) dryrun_multichip({n})", flush=True)
    t0 = time.perf_counter()
    res = dryrun_multichip(n)
    out["dryrun"] = dict(loss=res["loss"], s=time.perf_counter() - t0)
    print(f"multichip (c) cli.train --mesh auto on {n} cards", flush=True)
    with tempfile.TemporaryDirectory(prefix="multichip_",
                                     dir=os.path.join(REPO, "build")) as tmp:
        out["cli_s"] = multichip_cli(n, tmp)
    if n >= 4 and n % 2 == 0:
        shape = (2, n // 2)
        print(f"multichip (d) the space axis on a {shape[0]}x{shape[1]} NCCL "
              f"mesh, one card per rank: phase 25 (a), (b) and (d)",
              flush=True)
        out["space"] = space_runs(dev, shape, "cuda", "nccl", "multichip (d)")
    print(json.dumps({"multichip": out}))
    print(f"all multichip checks passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    try:
        print(nvidia_smi("name,power.limit"))
    except RuntimeError as e:
        fail(str(e))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": n}}))


class PhaseClock:
    """Prints each phase's header and, at the next one, the seconds the
    phase took."""

    def __init__(self):
        self.name, self.t = "", 0.0

    def __call__(self, header: str = "") -> None:
        """Close the running phase; then print ``header`` (none: the last
        phase ended) and start timing the phase it names."""
        now = time.perf_counter()
        if self.name:
            print(f"  {self.name}: {now - self.t:.1f} s", flush=True)
        self.name, self.t = " ".join(header.split()[:2]), now
        if header:
            print(header, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of one forward")
    ap.add_argument("--multichip", action="store_true",
                    help="only the data-parallel path, one rank on each "
                    "visible card (needs two or more)")
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
    if args.multichip:
        multichip_main(name)
        return

    t_start = t0 = time.perf_counter()
    phase = PhaseClock()
    lib = _build.load_library()
    phase(f"phase 1 build: {lib.build_seconds:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with load) -> {lib.path.name}")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")

    grids = rotation_grids(H, W).to_device(dev)
    phase("phase 2 dccl lookup kernel vs plain")
    lookup = phase_lookup(dev, grids, peaks)
    phase("phase 3 instance-norm sums kernel vs plain")
    sums = phase_sums(dev, peaks)

    phase("phase 4 forward")
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

    phase("phase 5 card vs CPU, 128x256, 4 iterations, f32")
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
    precision = phase_precision(dev, ref, c1, c2)
    print(json.dumps({"card_vs_cpu_ratio_at_torch_defaults": precision}))

    grids2 = rotation_grids(H2, W2).to_device(dev)
    phase(f"phase 6 cross-tap-coords kernel vs plain, {H2}x{W2} planes route")
    coords = phase_coords(dev, grids, grids2, peaks)
    phase("phase 7 volume-scatter kernel vs plain")
    scatter = phase_scatter(dev, grids, peaks)
    phase("phase 8 instance-norm sums of a train step")
    sums_train = phase_sums_backward(dev, peaks)
    del model32
    torch.cuda.empty_cache()
    phase(f"phase 9 train step, {H}x{W}, batch {TRAIN_B}, {ITERS} iterations, "
          f"bf16")
    train = phase_train(dev)
    print(json.dumps({"train_ms_per_step": {m: train[m]["ms"] for m in
                                            ("standard", "taped")},
                      "train_peak_gb": {m: train[m]["peak_gb"] for m in
                                        ("standard", "taped")}}))
    if args.profile:
        for mode in ("standard", "taped"):
            profile_train_step(dev, mode)
    phase("phase 10 train step, card vs CPU, 128x256, 2 iterations, f32")
    _, planes_counts = phase_train_card_vs_cpu(dev)

    phase(f"phase 11 lookup at given cross coords vs plain and kernel 1, "
          f"{H2}x{W2}")
    lookup_coords = phase_lookup_coords(dev, grids2, peaks)
    phase("phase 12 all levels in one launch vs per-level launches")
    all_levels = phase_all_levels(dev, grids, peaks)
    phase("phase 13 chunked pyramid build vs dense")
    pyramids = phase_pyramid_lean(dev)
    phase(f"phase 14 forward {H2}x{W2}; forced routes vs CPU; fused levels")
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
    del hr["fp32"]["model"], hr["bf16"]["model"]
    torch.cuda.empty_cache()

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = max_sm_clock_hz()
    phase(f"phase 15 primitive-rate anchors ({sms} SMs, max SM clock "
          f"{clock_hz / 1e6:.0f} MHz)")
    chain, plan, copy, tool_anchor = phase_anchors(dev, peaks, sms, clock_hz)
    phase(f"phase 16 DCCL stage split, {H}x{W}, batch 1")
    stages, tool_split = phase_stage_split(dev, peaks)
    phase("phase 17 grid-window variants")
    variant, pair, one_branch, tool_gridwin = phase_gridwin(dev, peaks)
    tool = {k: tool_anchor[k] + tool_split[k] + tool_gridwin[k]
            for k in tool_anchor}
    serving_compiles = start_serving_compiles()
    phase(f"phase 18 evaluation path, {H}x{W}: cli.evaluate, cli.video, "
          f"cli.demo_image")
    ev = phase_eval(dev, ms32)
    print(json.dumps({"eval_ms_per_pair": ev["ms_per_pair"],
                      "forward_ms_per_pair_fp32": ms32,
                      "eval_stages_ms_per_pair": ev["stages_ms_per_pair"],
                      "eval_host_share": ev["host_share"],
                      "eval_card_vs_cpu_rel": ev["card_vs_cpu_rel"],
                      "eval_batch2_rel": ev["batch_rel"]}))

    phase(f"phase 19 training CLI, {H}x{W}, batch {TRAIN_B}, {ITERS} "
          f"iterations, bf16")
    tc = phase_train_cli(dev, train)
    print(json.dumps({k: v for k, v in tc.items() if k != "counts"}))

    phase(f"phase 20 serving, {H}x{W} and {H2}x{W2}: torch.library ops, "
          f"exported programs, AOTInductor packages, cli.export")
    sv = phase_serving(dev, serving_compiles)
    print(json.dumps({"serving_ms_per_pair": {
        tag: sv[tag]["ms"] for tag in ("fp32", "bf16")},
        "serving_1024x2048_ms_per_pair": sv["hr"]["ms"],
        "serving_compile_s": {tag: {k: v for k, v in sv[tag].items()
                                    if k.startswith("compile_s")}
                              for tag in ("fp32", "bf16")},
        "serving_export_s": {tag: sv[tag]["export_s"]
                             for tag in ("fp32", "bf16")},
        "serving_compile_wall_s": sv["compile_wall_s"],
        "serving_aot_err_ratio": {tag: {k: v for k, v in sv[tag].items()
                                        if k.startswith(("aot_err",
                                                         "aot_gate"))}
                                  for tag in ("fp32", "bf16")},
        "serving_conv_kernel_launches": {
            tag: sum(sv[tag]["conv_kernels"].values())
            for tag in ("fp32", "bf16")},
        "serving_step_down": sv["step_down"],
        "serving_sensitivity_1e-3_grey": sv["sensitivity"],
        "serving_export_err": {tag: sv[tag]["export_err"]
                               for tag in ("fp32", "bf16")},
        "serving_cli_check_err": sv["cli_check_err"]}))

    phase(f"phase 21 memory-scale modes: on-the-fly correlation ({H2}x{W2} "
          f"against the volume route, {H3}x{W3} bf16), rematerialisation at "
          f"the EFT recipe, on-the-fly training")
    sc = phase_scale(dev, peaks)
    print(json.dumps({
        "onthefly_field_rel_1024x2048": sc["field_rel"],
        "onthefly_tap_path_2048x4096": sc["tap_path"],
        "onthefly_vs_volume_ratio_1024x2048": {
            k: v for k, v in sc["hr"].items() if k.startswith("ratio")},
        "forward_onthefly_2048x4096": {k: sc["big"][k] for k in (
            "ms", "runs", "warm_s", "peak_gb", "volume_gb")},
        "sums_err_2048x4096": sc["big_kernels"]["sums_err"],
        "remat_eft": {f"{m}_{p}": v for (m, p), v in sc["remat"].items()},
        "train_onthefly_512x1024": {
            **{k: sc["train_otf"][k] for k in ("loss_rel", "grad_rel",
                                               "grad_gate", "sens",
                                               "worst_tensor",
                                               "worst_tensor_quantised",
                                               "worst_fnet",
                                               "worst_fnet_quantised")},
            **{f"{k}_{q}": v[q] for k, v in sc["train_otf"]["res"].items()
               for q in ("ms", "peak_gb")}}}))

    phase(f"phase 22 data parallel on one card: a one-rank NCCL mesh at the "
          f"EFT recipe, {DP_RANKS} gloo ranks sharing the card, NCCL refusing "
          f"them, dryrun_multichip({DP_RANKS})")
    dp = phase_parallel(dev)
    print(json.dumps({
        "dp_world1_nccl": dp["world1"],
        "dp_two_ranks_gloo_one_card": {
            m: {k: v for k, v in r.items() if k != "launches"}
            for m, r in dp["two_ranks"].items()},
        "dp_nccl_two_ranks_one_card": dp["nccl_shared"],
        "dryrun_multichip": dp["dryrun"]}))

    phase(f"phase 23 lookup modes mxu and gather, {H}x{W}, against the kernel "
          f"route; the mxu program on cuda and cpu")
    lm = phase_lookup_modes(dev, grids)
    print(json.dumps({"lookup_mode_fields": lm["fields"],
                      "lookup_mode_forward": {
                          m: {k: v for k, v in r.items() if k != "counts"}
                          for m, r in lm["forward"].items()},
                      "lookup_mode_export": lm["export"]}))

    phase(f"phase 24 deferred volume gradients at the EFT recipe; RAFT basic "
          f"and small, {RAFT_H}x{RAFT_W}; batch-statistics BatchNorm")
    p24 = phase_deferred_raft(dev, train)
    d24 = p24["deferred"]
    print(json.dumps({
        "train_deferred": {k: v for k, v in d24.items() if k != "counts"},
        "train_ms_per_step_phase9": {m: train[m]["ms"] for m in
                                     ("standard", "taped")},
        "raft_440x1024": {tag: {k: v for k, v in r.items() if k != "counts"}
                          for tag, r in p24["raft"].items()},
        "bn_batch_statistics": p24["bn"]}))

    phase(f"phase 25 the space axis: a {SP_SHAPE[0]}x{SP_SHAPE[1]} mesh of "
          f"gloo ranks sharing the card, the EFT step at {H}x{W} (standard, "
          f"taped, deferred), the {H2}x{W2} forward, the mxu / gather "
          f"forwards, RAFT at {SP_RAFT_HW[0]}x{SP_RAFT_HW[1]}, PriOr-RAFT "
          f"at {SP_UNEVEN_HW[0]}x{SP_UNEVEN_HW[1]} (forward and step), the "
          f"batch-statistics step; dryrun_multichip(4) on a 2x2 mesh")
    sp = phase_space(dev)
    no_launches = lambda d: {k: ({q: v for q, v in r.items()
                                  if q != "launches"}
                                 if isinstance(r, dict) else r)
                             for k, r in d.items()}
    print(json.dumps({"space_1x2": {
        "sums_f64_rel": sp["sums_f64_rel"],
        "step": no_launches(sp["step"]),
        "forward_1024x2048": no_launches(sp["forward"]),
        "modes": {**no_launches({k: v for k, v in sp["modes"].items()
                                 if k not in ("step", "uneven_step")}),
                  "step": no_launches(sp["modes"]["step"]),
                  "uneven_step": no_launches(sp["modes"]["uneven_step"])},
        "dryrun_multichip_2x2": sp["dryrun"], "s": sp["s"]}}))
    phase()
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    try:
        print(nvidia_smi("name,power.limit"))
    except RuntimeError as e:
        fail(str(e))

    std, tap = train["standard"]["counts"], train["taped"]["counts"]
    hr_counts, fused_counts = hr["fp32"]["counts"], hr["fused"]["counts"]
    per_path = ("launches: one run of the path in launches_path; "
                "launches_train / launches_taped: one standard / taped train "
                "step (512x1024, batch 4, 12 iterations, bf16); "
                "launches_forward: one 512x1024 test-mode forward; "
                "launches_forward_1024x2048: one 1024x2048 forward; "
                "launches_train_planes: one standard step with the planes "
                "route forced (128x256, batch 1, 2 iterations, f32); "
                "launches_forward_fused_levels: one 512x1024 forward with "
                "PRIORFLOW_DCCL_FUSE_LEVELS=1; launches_eval_512x1024: per "
                "pair of cli.evaluate on the MPF test split at 512x1024, 12 "
                "iterations (phase 18); launches_train_cli: one standard "
                "run of cli.train (phase 19: 512x1024, batch 4, 12 "
                "iterations, bf16, 6 steps, 2 validations of 3 pairs, one "
                "image panel forward); the tools' kernels (path "
                "tool): one measurement run of phases 15-17; rows 1-5 also "
                "launches_serving_512x1024: one call of phase 20's "
                "AOTInductor package (512x1024, batch 1, 12 iterations, "
                "fp32), and launches_serving_1024x2048: one call of phase "
                "20's exported 1024x2048 program (the planes route); "
                "launches_forward_onthefly_2048x4096: one 2048x4096 bf16 "
                "forward with corr_mode='onthefly' (phase 21: rows 2 and 5, "
                "one coords launch per query chunk and iteration); "
                "launches_train_step_dp2_per_rank: one standard step of one "
                "of phase 22 (b)'s two gloo ranks (512x1024, batch 1 of a "
                "global 2, 12 iterations, fp32); "
                "launches_forward_mxu_512x1024: one 512x1024 fp32 forward "
                "with lookup_mode='mxu' (phase 23: no lookup kernel, the "
                "encoders' sums); launches_train_deferred: one standard "
                "step with deferred_vol_grad=True (phase 24: 512x1024, batch "
                "4, 12 iterations, bf16; the lookups in the recording pass, "
                "one stacked scatter per level and volume); "
                "launches_raft_basic_440x1024 / _small_: one 440x1024 fp32 "
                "forward of the legacy RAFT, 12 iterations (phase 24: the "
                "feature encoder's sums); launches_train_step_sp2_per_rank: "
                "one standard step of one of phase 25 (a)'s two gloo ranks "
                "of a 1x2 data x space mesh (512x1024 split in two height "
                "slices, global batch 2, 12 iterations, fp32, remat dccl; "
                "the sums with f64 partial sums); "
                "launches_train_taped_sp2_per_rank / _deferred_: the same "
                "step in the taped grad mode / with deferred_vol_grad=True "
                "(phase 25 (a): one stacked scatter per level and volume); "
                "launches_forward_1024x2048_sp2_per_rank: one 1024x2048 "
                "fp32 forward of one of phase 25 (b)'s two ranks (the planes "
                "route); launches_forward_mxu_sp2_per_rank: one 512x1024 "
                "fp32 forward with lookup_mode='mxu', 3 iterations, of one "
                "of phase 25 (d)'s two ranks (no lookup kernel); "
                "launches_raft_basic_440x1024_sp2_per_rank / _small_: one "
                "440x1024 fp32 RAFT forward, 12 iterations, of one of phase "
                "25 (d)'s ranks (strips of 224 and 216 rows); "
                "launches_train_bn_64x128_sp2_per_rank: one "
                "standard step with bn_running_average=False at 64x128, "
                "global batch 2, 12 iterations, of one of phase 25 (d)'s "
                "ranks; launches_forward_520x1040_sp2_per_rank: one "
                "520x1040 fp32 forward, 3 iterations, of one of phase 25 "
                "(d)'s ranks (H / 8 = 65: strips of 264 and 256 rows; the "
                "planes route); launches_train_step_520x1040_sp2_per_rank: "
                "one standard step at 520x1040, global batch 2, 1 "
                "iteration, fp32, of one of phase 25 (d)'s ranks (the "
                "planes route: the given-coords scatter); "
                "launches_train_bn_64x128_dp2_per_rank: one standard step "
                "with bn_running_average=False at 64x128, 1 iteration, of "
                "one of phase 22 (b)'s two data-only ranks (batch 1 of a "
                "global 2)")

    def row(name, src, replaces, d, work, err, path="train"):
        paths = {"train": std, "forward_1024x2048": hr_counts,
                 "forward_fused_levels": fused_counts, "tool": tool,
                 "train_planes": planes_counts}
        return {"name": name, "route": "cuda",
                "source": f"prior_flow_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": paths[path][name],
                "launches_path": path, "launches_train": std[name],
                "launches_taped": tap[name],
                "launches_forward": counts.get(name, 0),
                "launches_forward_1024x2048": hr_counts[name],
                "launches_forward_fused_levels": fused_counts[name],
                "launches_train_planes": planes_counts[name],
                "launches_eval_512x1024": ev["counts_per_pair"][name],
                "launches_train_cli": tc["counts"]["standard"][name],
                "launches_forward_onthefly_2048x4096":
                    sc["big"]["counts"][name],
                "launches_train_step_dp2_per_rank":
                    dp["two_ranks"]["standard"]["launches"].get(name, 0),
                "launches_forward_mxu_512x1024":
                    lm["forward"]["mxu"]["counts"][name],
                "launches_train_deferred": d24["counts"][name],
                "launches_raft_basic_440x1024":
                    p24["raft"]["basic"]["counts"][name],
                "launches_raft_small_440x1024":
                    p24["raft"]["small"]["counts"][name],
                "launches_train_step_sp2_per_rank":
                    sp["step"][f"standard_{ITERS}"]["launches"].get(name, 0),
                "launches_train_taped_sp2_per_rank":
                    sp["step"][f"taped_{ITERS}"]["launches"].get(name, 0),
                "launches_train_deferred_sp2_per_rank":
                    sp["step"][f"deferred_{ITERS}"]["launches"].get(name, 0),
                "launches_forward_1024x2048_sp2_per_rank":
                    sp["forward"][ITERS]["launches"].get(name, 0),
                "launches_forward_mxu_sp2_per_rank":
                    sp["modes"]["mxu"]["launches"].get(name, 0),
                "launches_raft_basic_440x1024_sp2_per_rank":
                    sp["modes"]["raft_basic"]["launches"].get(name, 0),
                "launches_raft_small_440x1024_sp2_per_rank":
                    sp["modes"]["raft_small"]["launches"].get(name, 0),
                "launches_forward_520x1040_sp2_per_rank":
                    sp["modes"]["uneven"]["launches"].get(name, 0),
                "launches_train_step_520x1040_sp2_per_rank":
                    sp["modes"]["uneven_step"][f"standard_{SP_SHORT}"][
                        "launches"].get(name, 0),
                "launches_train_bn_64x128_dp2_per_rank":
                    dp["two_ranks"]["bn"][f"batch-statistics_{SP_SHORT}"][
                        "launches"].get(name, 0),
                "launches_train_bn_64x128_sp2_per_rank":
                    sp["modes"]["step"][f"batch-statistics_{ITERS}"][
                        "launches"].get(name, 0),
                "max_abs_err": err, "ms": d["ms"], "plain_ms": d["plain_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "library_ms": d["library_ms"], "work": work + "; " + per_path,
                **({"launches_serving_512x1024": sv["fp32"]["counts"][name],
                    "launches_serving_1024x2048": sv["hr"]["counts"][name]}
                   if name in SERVED else {})}

    lk = lookup["f32"]
    kernels = [
        row("dccl_level_lookup", "dccl_lookup.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:239", lk,
            "ms/plain/bound/library: one GRU iteration, 4 level launches, f32 "
            "volumes, 512x1024, batch 1; library_ms = 4 F.grid_sample per "
            "level at precomputed cross coords (leaves out the grid-window "
            "stage); issued back to back; with launches queued ahead (the "
            f"card's own time): kernel {lk['queued_ms']:.4f} ms, library "
            f"{lk['library_queued_ms']:.4f} ms; the grid-route DCCLFused call "
            f"per iteration: {lk['call_ms']:.4f} ms, queued "
            f"{lk['call_queued_ms']:.4f} ms",
            max(lk["err"], lookup["bf16"]["err"])),
        row("instance_norm_sums", "instance_norm.cu",
            "prior_flow_tpu/ops/pallas/instance_norm.py:52", sums_train,
            "ms/plain/bound/library: one batch-4 train step's 30 sums, 15 "
            "forward (x, x) bf16 and 15 backward (xhat, dy) f32 at B = 16, "
            "issued back to back; queued (the card's own time): "
            f"{sums_train['queued_ms']:.4f} ms; "
            "library_ms = torch.var_mean(x) + torch.linalg.vecdot(xhat, dy) "
            "(leaves out sum(dy))", max(sums_train["err"], sums["f32"]["err"],
                                        sums["bf16"]["err"])),
        row("dccl_cross_coords", "dccl_coords.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:1033", coords,
            "ms/plain/bound/library: one 1024x2048 forward's 12 launches on "
            "the planes route (one per iteration: both branches, 4 levels x "
            "32768 centres, the level scale applied inside), issued back to "
            f"back; queued (the card's own time): {coords['queued_ms']:.4f} "
            f"ms, library {coords['library_queued_ms']:.4f} ms; library_ms "
            "= 2 F.grid_sample per iteration, each grid at its precomputed "
            "normalised window coords (leaves out the window and the wrap)",
            coords["err"], path="forward_1024x2048"),
        row("dccl_grid_coords", "dccl_coords.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:1033", one_branch,
            "ms/plain/bound/library: the coords kernel's one-branch "
            "one-level entry, two launches (branch A, branch B) at the "
            "gridwin tool's shapes (Q = 8192, 64x128 grids, scale 1), "
            "queued; the main paths launch the both-branch entry instead; "
            "plain_ms, library_ms and bound_ms those of gridwin_pair, the "
            "same work", one_branch["err"], path="tool"),
        row("dccl_level_scatter_grid", "dccl_scatter.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:715 (_scatter_own_cross; "
            "stacked: :1108, :1152)", scatter["grid"],
            "ms/plain/bound/library: one taped step's 8 launches, S = 12, "
            "batch 4, bf16 output, the cross tap coords computed inside; "
            "library_ms = index_put_(accumulate=True) of the precomputed "
            "weighted corners into f32 (leaves out the coords, the corners, "
            "the zeroing and the cast); one standard step's 96 S=1 "
            f"launches: {scatter['grid']['standard_step_ms']:.4f} ms, bound "
            f"{scatter['grid']['standard_bound_ms']:.4f} ms",
            scatter["grid"]["err"]),
        row("dccl_level_scatter", "dccl_scatter.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:715 (_scatter_own_cross, "
            "the planes route's VJP :783-821)", scatter["given"],
            "ms/plain/bound/library: the given-coords entry at a taped step's "
            "shapes, 8 launches, S = 12, batch 4, bf16 output; library_ms = "
            "index_put_(accumulate=True) of the precomputed weighted corners "
            "(leaves out the corners, the zeroing and the cast); 96 S=1 "
            f"launches: {scatter['given']['standard_step_ms']:.4f} ms",
            scatter["given"]["err"], path="train_planes"),
        row("dccl_level_lookup_coords", "dccl_lookup.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:314",
            lookup_coords["f32"],
            "ms/plain/bound/library: one GRU iteration of the 1024x2048 "
            "forward, 4 level launches at given coords, f32 volumes, batch 1 "
            "(B x Q = 32768); library_ms = 4 F.grid_sample per level at the "
            "given coords; issued back to back; queued (the card's own "
            f"time): {lookup_coords['f32']['queued_ms']:.4f} ms; the route's "
            "coords launch per iteration: "
            f"{lookup_coords['f32']['coords_ms']:.4f} ms, queued "
            f"{lookup_coords['f32']['coords_queued_ms']:.4f} ms; kernel 1 at "
            f"the same shapes: {lookup_coords['f32']['grid_route_ms']:.4f} "
            f"ms, queued {lookup_coords['f32']['grid_route_queued_ms']:.4f} "
            "ms", 
            max(lookup_coords["f32"]["err"], lookup_coords["bf16"]["err"]),
            path="forward_1024x2048"),
        row("dccl_lookup_all_levels", "dccl_lookup.cu",
            "prior_flow_tpu/ops/pallas/dccl_gather.py:271", all_levels,
            "ms/plain/bound/library: one GRU iteration at 512x1024, batch 1, "
            "f32, one launch for 4 levels; library_ms = 16 F.grid_sample at "
            "precomputed coords (leaves out the grid-window stage); issued "
            "back to back; queued (the card's own time): "
            f"{all_levels['queued_ms']:.4f} ms; 4 per-level launches: "
            f"{all_levels['per_level_ms']:.4f} ms, queued "
            f"{all_levels['per_level_queued_ms']:.4f} ms",
            all_levels["err"], path="forward_fused_levels"),
        row("anchor_chain", "microbench_anchor.cu",
            "tools/microbench_vpu_anchor.py:46", chain,
            "ms/plain/bound: the six (kind, ilp) chains of the anchor tool, "
            "one launch each, 128 x (512, 128) f32, K = 256, summed, the "
            "gathers on a plan built once (row gather_plan); per "
            f"chain ms {chain['per']}; the bound of each gather counts its "
            "plan's bytes; max_abs_err over finite outputs; library_ms "
            "null: no single PyTorch call computes a 256-deep dependent "
            "chain", chain["err"], path="tool"),
        row("gather_plan", "microbench_anchor.cu",
            "tools/microbench_vpu_anchor.py:46", plan,
            "ms/plain/bound: the gather chains' read schedule of the anchor "
            f"tool's idx ({plan['rows']} rows, one thread per row, two Euler "
            "splits), one launch, queued, timed apart from the chains; "
            "bitwise its plain version (max_abs_err 0); shared-memory "
            "wavefronts per row-step modelled from idx: old layout "
            f"{plan['wavefronts_old']:.3f}, plan "
            f"{plan['wavefronts_plan']:.3f}; library_ms null: no PyTorch "
            "call computes an edge coloring", plan["err"], path="tool"),
        row("step_cost_copy", "microbench_anchor.cu",
            "tools/microbench_vpu_anchor.py:91", copy,
            "ms/plain/bound/library: o = 2x over 4096 (8, 128) f32 tiles, "
            "one block each, every call on inputs and outputs out of the L2 "
            "(512 tiles: "
            f"{copy['small_ms']:.4f} ms; slope {copy['slope_us']:.4f} us per "
            f"block; empty launch {copy['empty_us']:.3f} us queued, "
            f"{copy['empty_paced_us']:.3f} us issued back to back); ms, "
            "plain_ms and library_ms with launches queued ahead; library_ms = "
            "torch.mul(x, 2.0), the plain version's own call", copy["err"],
            path="tool"),
        row("dccl_own_only", "dccl_stages.cu",
            "tools/microbench_kernel_split.py:70", stages["own_only"],
            "ms/plain/bound/library: the own-taps stage of kernel 1 alone, "
            "512x1024, batch 1, f32, four level launches summed; library_ms "
            "= one F.grid_sample per level of both volumes stacked on the "
            "batch at precomputed normalised window coords (leaves out the "
            "window)", stages["own_only"]["err"], path="tool"),
        row("dccl_gridwin_only", "dccl_stages.cu",
            "tools/microbench_kernel_split.py:81", stages["gridwin_only"],
            "ms/plain/bound/library: the grid-window stage of kernel 1 alone "
            "(both branches' cross tap coords), kernel 1's column body, "
            "512x1024, batch 1, four level launches summed; library_ms = one "
            "F.grid_sample per level of both grids stacked on the batch at "
            "precomputed normalised window coords (leaves out the window)",
            stages["gridwin_only"]["err"], path="tool"),
        row("dccl_cross_only", "dccl_stages.cu",
            "tools/microbench_kernel_split.py:93", stages["cross_only"],
            "ms/plain/bound: kernel 1's grid window and cross taps, no own "
            "taps, 512x1024, batch 1, f32, four level launches summed; "
            "library_ms null: the second sampling reads the first's output, "
            "no single call computes both",
            stages["cross_only"]["err"], path="tool"),
        row("gridwin_pair", "dccl_coords.cu",
            "tools/microbench_gridwin.py:358", pair,
            "ms/plain/bound/library: both branches' coords at their own "
            "centres (B reversed), Q = 8192, 64x128 grids, scale 1, one "
            "launch of the coords kernel's both-branch entry, queued; "
            "library_ms = 2 F.grid_sample of the grids at precomputed "
            "normalised window coords", pair["err"], path="tool"),
        row("gridwin_variant", "gridwin_variants.cu",
            "tools/microbench_gridwin.py:394", variant,
            "ms/plain/bound/library: the smem_grid variant (both grids "
            "staged in shared memory), Q = 8192, 64x128 grids, scale 1, "
            "queued; the direct variant is dccl_coords.cu's "
            "dccl_cross_coords at one centre set (the gridwin_pair row's "
            f"kernel): {variant['direct_ms']:.4f} ms, the same bound; "
            "launches: the wrapper's, every variant and diagnostic; every "
            "variant, diagnostic and two coords-kernel launches (ms): "
            f"{variant['per']}; library_ms = 2 F.grid_sample at precomputed "
            "normalised window coords", variant["err"], path="tool"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
