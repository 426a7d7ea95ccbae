"""The traced window: a ``torch.profiler`` trace of the card's activity
and the host's ops, written as a Chrome trace inside the checkout and
reduced to what the per-layer readers take.

Reduction: every device event (kernels, copies, sets) as an interval;
``busy_s`` their union inside the window, ``window_s`` the window's
length (the host annotation ``bench.window``, which ends after a
synchronise); kernel device time summed by name; kernel launches counted;
the longest idle gaps (``GAPS_NAMED`` of them) named by the innermost
host op running at their middle.
"""

from __future__ import annotations

import collections
import json
import re
from pathlib import Path

import numpy as np
import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# convolution and matrix-product kernels (cuDNN, cuBLAS, CUTLASS) by name
CONV = re.compile(r"conv|cudnn|gemm|xmma|cutlass|sm90_|sm80_|wgrad|dgrad|fprop|"
                  r"nchwtonhwc|nhwctonchw|winograd|implicit", re.I)
PORT = re.compile(r"dccl_|row_sums_kernel")
# the longest idle gaps that are named by the host op beside them
GAPS_NAMED = 200


class Tracer:
    """Context manager around the traced window; ``summary`` after exit."""

    def __init__(self, path: Path):
        self.path = path
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.mark = record_function(WINDOW)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
            self.summary = reduce(load(self.path))
        return False


def load(path: Path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def reduce(events: list) -> dict:
    """The summary of one traced window (times in seconds)."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace has no window annotation")
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev, by_name, launches, copy_s = [], collections.Counter(), 0, 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            by_name[e["name"]] += (b - a) * 1e-6
            launches += 1
        else:
            copy_s += (b - a) * 1e-6
    busy, merged = _union(dev)
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"
            and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    named = collections.Counter()
    if host:
        ts = np.array([e["ts"] for e in host], dtype=np.float64)
        end = ts + np.array([e.get("dur", 0) for e in host], dtype=np.float64)
        for a, b in sorted(gaps, key=lambda ab: ab[0] - ab[1])[:GAPS_NAMED]:
            mid = 0.5 * (a + b)
            inside = np.flatnonzero((ts <= mid) & (end >= mid))
            who = (host[inside[np.argmin(end[inside] - ts[inside])]]["name"]
                   if inside.size else "(no host op)")
            named[who] += (b - a) * 1e-6
    kernels = dict(by_name)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6, "launches": launches,
            "kernel_s": kernels, "copy_s": copy_s,
            "conv_s": sum(t for n, t in kernels.items() if CONV.search(n) and not PORT.search(n)),
            "port_s": sum(t for n, t in kernels.items() if PORT.search(n)),
            "top_ops": sorted([*kernels.items(), ("(copies and sets)", copy_s)],
                              key=lambda kv: -kv[1])[:10],
            "idle_gaps": named.most_common(10)}


def kernel_s(summary: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(t for n, t in summary["kernel_s"].items() if rx.search(n))


def trace_path(workload: str) -> Path:
    """A fixed path inside the checkout, overwritten by each traced run."""
    return Path(__file__).resolve().parents[1] / "build" / "bench_trace" / f"{workload}.json"
