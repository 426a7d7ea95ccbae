"""The driver a traffic mix names (``mode``): ``closed_loop`` inference.
It builds the program from the seeded state dict, warms up every shape
the mix uses, measures for the run's seconds, optionally traces a few
batches at the start of the window, and after the window (peak memory
read, the program freed) runs the frozen reference on what the window
produced.
"""

from __future__ import annotations

import math
import random
import statistics
import time

import torch

from . import check, traffic
from .reference.common import Arith, no_tf32
from .trace import Tracer, trace_path


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Outcome:
    """What a driver hands back to ``run.run_cell``."""

    def __init__(self):
        self.setup_s = math.nan
        self.values = {}          # end-to-end metric name -> value
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.stages = {}          # set-up, seconds by stage
        self.summary = None       # the traced window's reduction
        self.units = 0            # pairs inside the traced window
        self.numbers = {}         # the correctness numbers
        self.diag = {}


def _picks(seed: int, tr) -> dict:
    """The window's answers that are checked, drawn from the seed: batch
    index -> the rows of that batch."""
    rng = random.Random(int(seed) ^ 0x5EED)
    batches = sorted(rng.sample(range(tr["check_among"]), tr["check_batches"]))
    return {i: sorted(rng.sample(range(tr["batch"]), tr["check_pairs"])) for i in batches}


def ref_rows(tr, dev) -> int:
    return tr["ref_rows"] if dev.type == "cuda" else 1


def reference_flows(fam, cfg, sd, a, b, rows, arith: str):
    """The reference's test-mode flows of uint8 pairs, ``rows`` at a time."""
    outs = []
    with torch.no_grad(), no_tf32():
        for r in range(0, a.shape[0], rows):
            outs.append(fam.reference.forward(sd, cfg, a[r:r + rows].float(),
                                              b[r:r + rows].float(), cfg["iters"],
                                              Arith(arith)).cpu())
    return torch.cat(outs)


def closed_loop(cell, fam, sd, seed, seconds, trace, dev, t0) -> Outcome:
    """One client sends a batch of pairs, waits for its flows, sends the
    next: each batch's host frames copied in, the test-mode forward, a
    synchronise."""
    tr, cfg = cell.traffic, cell.config
    B, H, W = tr["batch"], tr["height"], tr["width"]
    o = Outcome()
    lap = time.perf_counter()

    def stage(name):
        nonlocal lap
        sync(dev)
        now = time.perf_counter()
        o.stages[name] = now - lap
        lap = now

    model = fam.build(cfg, sd, tr, dev)
    stage("build")
    im1, im2 = traffic.make_pairs(tr["pool_pairs"], H, W, traffic.flow_rms(tr),
                                        seed, traffic.FRAMES, dev)
    stage("frames")
    nb = tr["pool_pairs"] // B
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def serve(i):
        k = i % nb
        a = im1[k * B:(k + 1) * B].to(dev, non_blocking=True).float()
        b = im2[k * B:(k + 1) * B].to(dev, non_blocking=True).float()
        return model(a, b, iters=cfg["iters"])

    for i in range(tr["warmup_batches"]):
        serve(i)
        stage(f"warmup{i}")
    o.setup_s = time.perf_counter() - t0
    picks = _picks(seed, tr)
    last = max(picks)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    lat, kept, tracer, i = [], {}, None, 0
    t_start = time.perf_counter()
    while True:
        if trace and i == 0:
            tracer = Tracer(trace_path(cell.name)).__enter__()
        tb = time.perf_counter()
        flow = serve(i)
        bad += (~torch.isfinite(flow)).flatten(1).any(1).sum()
        sync(dev)
        te = time.perf_counter()
        lat.append(te - tb)
        if tracer is not None and i + 1 == tr["trace_batches"]:
            tracer.__exit__(None, None, None)
            o.summary, o.units, tracer = tracer.summary, tr["trace_batches"] * B, None
        if i in picks:
            kept[i] = flow[picks[i]].float().cpu()
        i += 1
        if te - t_start >= seconds and i > last and tracer is None:
            break
    o.values["pairs_per_s"] = i * B / (te - t_start)
    o.attempted, o.failed = i * B, int(bad)
    o.peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    o.diag = {"batches": i, "batch_ms_min": 1e3 * min(lat),
              "batch_ms_median": 1e3 * statistics.median(lat), "batch_ms_max": 1e3 * max(lat)}
    del model, flow
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    progs, refs = [], []
    for i, prog in kept.items():
        a, b = checked_pairs(im1, im2, i, picks[i], nb, B, dev)
        refs.append(reference_flows(fam, cfg, sd, a, b, ref_rows(tr, dev), "fp32"))
        progs.append(prog)
    o.numbers = check.flow_numbers(torch.cat(progs), torch.cat(refs))
    o.diag["reference_s"] = time.perf_counter() - t
    o.diag["checked_pairs"] = sum(p.shape[0] for p in progs)
    return o


def checked_pairs(im1, im2, i, rows, nb, B, dev):
    """The host frames of window batch ``i``'s checked ``rows``, on ``dev``."""
    idx = torch.tensor([(i % nb) * B + r for r in rows])
    return im1[idx].to(dev), im2[idx].to(dev)


DRIVERS = {"closed_loop": closed_loop}
