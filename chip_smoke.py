#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure (non-zero exit, no result line):
1. build the CUDA kernels from ``prior_flow_tpu_torch/csrc``;
2. the DCCL level-lookup kernel against its plain version at the four
   pyramid-level shapes of a 512x1024 forward, f32 and bf16 volumes;
3. the instance-norm sums kernel against its plain version at the three
   fnet shapes, f32 and bf16;
4. the test-mode forward at 512x1024, batch 1, 12 iterations, seeded
   random weights, fp32 then mixed precision: output shape, finiteness,
   launch counts per forward (48 lookups, 15 norms), median ms/pair;
5. the same weights on the card and on the CPU at 128x256, 4 iterations.
Then the card's name and power limit, a ``kernels`` JSON line with each
kernel's launches, error, times and bound, and the result line.

TF32 is off for matmuls and cuDNN convolutions in every phase, so "fp32"
is full f32 and the card-vs-CPU comparison is like for like.
``--profile`` adds a torch.profiler kernel breakdown of one forward per
precision. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

H, W, ITERS = 512, 1024, 12
FNET_SHAPES = [(4, 64, 256, 512), (4, 96, 128, 256), (4, 128, 64, 128)]
NORMS_PER_SHAPE = 5
LOOKUP_ATOL = 2e-5        # unit-scale volumes; kernel and plain round alike
SUMS_RTOL = SUMS_ATOL = 1e-5
CARD_CPU_TOL = 1e-3       # max abs error / flow scale, 128x256, 4 iterations
# f32 operations per (query, tap) of one lookup launch, both branches,
# counted from the kernel's arithmetic (2 x (own 35 + grid 47 + cross 35 + 4))
LOOKUP_OPS_PER_TAP = 242


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

def lookup_inputs(lvl: int, dtype, dev, grids):
    import torch
    g = torch.Generator(device=dev).manual_seed(100 + lvl)
    h8, w8 = H // 8, W // 8
    Q = h8 * w8
    Hl, Wl = h8 >> lvl, w8 >> lvl
    vA = torch.randn(1, Q, Hl, Wl, generator=g, device=dev).to(dtype)
    vB = torch.randn(1, Q, Hl, Wl, generator=g, device=dev).to(dtype)
    # centres over the whole 1/8 image and a margin beyond it, with seam
    # columns, a hair below 0 and the pole rows pinned
    u = torch.rand(2, 1, Q, generator=g, device=dev)
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


def phase_lookup(dev, grids, peaks):
    import torch
    import torch.nn.functional as F
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
                sectors = (touched_sectors(vA, [coords[0], coords[3]])
                           + touched_sectors(vB, [coords[2], coords[1]]))
                nbytes = (sectors * 32 + 4 * BQ * NTAP * 4 + 2 * BQ * 2 * 4
                          + 2 * gA.numel() * 4)
                ops = BQ * NTAP * LOOKUP_OPS_PER_TAP
                b_ms, _ = bound(nbytes, ops, peaks)
                lib_ms = None
                if dtype == torch.float32 and Hl > 1 and Wl > 1:
                    def norm(c):
                        xn = torch.remainder(c[..., 0], Wl) * (2.0 / (Wl - 1)) - 1
                        yn = c[..., 1] * (2.0 / (Hl - 1)) - 1
                        return torch.stack([xn, yn], -1).reshape(BQ, 1, NTAP, 2)
                    gs = [norm(c) for c in coords]
                    iA = vA.reshape(BQ, 1, Hl, Wl)
                    iB = vB.reshape(BQ, 1, Hl, Wl)

                    def library():
                        for img, grid in ((iA, gs[0]), (iB, gs[1]),
                                          (iB, gs[2]), (iA, gs[3])):
                            F.grid_sample(img, grid, mode="bilinear",
                                          padding_mode="zeros",
                                          align_corners=True)
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
    return rows


# -- phase 3: instance-norm sums -----------------------------------------------

def phase_sums(dev, peaks):
    import torch
    from prior_flow_tpu_torch.ops.kernels.instance_norm import (
        instance_norm_sums, instance_norm_sums_plain)

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                   err=0.0)
        for shape in FNET_SHAPES:
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
            b_ms, _ = bound(nbytes, 2 * x.numel(), peaks)
            print(f"  sums {tag} {shape}: max abs err {err:.3e} kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms  var_mean "
                  f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms", flush=True)
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", 2 * x.numel())):
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


def phase_forward(dev, mixed: bool, i1, i2):
    import torch
    from prior_flow_tpu_torch import build_model
    from prior_flow_tpu_torch.ops.kernels import (launch_counts,
                                                  reset_launch_counts)
    tag = "bf16" if mixed else "fp32"
    model = build_model(seed=0, mixed_precision=mixed)   # default: the card
    model(i1, i2, iters=ITERS)                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    flow = model(i1, i2, iters=ITERS)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(flow.shape) != (1, H, W, 2):
        fail(f"{tag} forward: shape {tuple(flow.shape)}")
    if not bool(torch.isfinite(flow).all()):
        fail(f"{tag} forward: non-finite output")
    want = {"dccl_level_lookup": 4 * ITERS, "instance_norm_sums": 15}
    if counts != want:
        fail(f"{tag} forward: launch counts {counts}, expected {want}")
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        model(i1, i2, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    print(f"  forward {tag} {H}x{W} iters {ITERS}: launches {counts}; "
          f"median {med:.2f} ms/pair over {len(times)} runs "
          f"(min {min(times):.2f}, max {max(times):.2f}); peak "
          f"{peak_gb:.2f} GB; flow |max| {flow.abs().max().item():.3f}",
          flush=True)
    return model, flow, counts, med


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
    ours = sum(e.self_device_time_total for e in events
               if "dccl_level_kernel" in e.key or "row_sums_kernel" in e.key)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"  profile {tag}: wall {wall:.2f} ms (profiled), device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%), the two port kernels "
          f"{ours / 1e3:.3f} ms", flush=True)
    for e in events[:20]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


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

    t0 = time.perf_counter()
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
    model32, flow32, counts, ms32 = phase_forward(dev, False, i1, i2)
    model16, flow16, counts16, ms16 = phase_forward(dev, True, i1, i2)
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])

    lk, sm = lookup["f32"], sums["f32"]
    kernels = [
        {"name": "dccl_level_lookup", "route": "cuda",
         "source": "prior_flow_tpu_torch/csrc/dccl_lookup.cu",
         "replaces": "prior_flow_tpu/ops/pallas/dccl_gather.py:239",
         "launches": counts["dccl_level_lookup"],
         "max_abs_err": max(lk["err"], lookup["bf16"]["err"]),
         "ms": lk["ms"], "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
         "bound_by": lk["bound_by"], "library_ms": lk["library_ms"],
         "work": "one GRU iteration: 4 level launches, f32 volumes, 512x1024; "
                 "library_ms = 4 F.grid_sample per level at precomputed cross "
                 "coords (excludes the grid-window stage)"},
        {"name": "instance_norm_sums", "route": "cuda",
         "source": "prior_flow_tpu_torch/csrc/instance_norm.cu",
         "replaces": "prior_flow_tpu/ops/pallas/instance_norm.py:52",
         "launches": counts["instance_norm_sums"],
         "max_abs_err": max(sm["err"], sums["bf16"]["err"]),
         "ms": sm["ms"], "plain_ms": sm["plain_ms"], "bound_ms": sm["bound_ms"],
         "bound_by": sm["bound_by"], "library_ms": sm["library_ms"],
         "work": "one forward's 15 fnet norms, f32; library_ms = "
                 "torch.var_mean(x, dim=(2, 3))"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
