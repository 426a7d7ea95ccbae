"""What the per-layer metric files read from a traced window.

``ctx``: ``cell`` (spec.Cell), ``family``, ``summary`` (trace.reduce's),
``units`` (the pairs of the traced window). A
reader that finds nothing to read returns None and the metric is left
out of the result line.
"""

from __future__ import annotations

import torch

from . import flops
from .trace import kernel_s

LOOKUP = r"dccl_level_kernel|dccl_all_levels_kernel"


def mfu(ctx):
    s = ctx["summary"]
    if not s["window_s"]:
        return None
    tr = ctx["cell"].traffic
    peak, _ = flops.peak_flops(tr)
    work = flops.pair_flops(ctx["family"], ctx["cell"].config, tr) * ctx["units"]
    return 100.0 * work / s["window_s"] / peak


def launches(ctx):
    return ctx["summary"]["launches"] / ctx["units"]


def conv_ms(ctx):
    return 1e3 * ctx["summary"]["conv_s"] / ctx["units"]


def plain_ms(ctx):
    s = ctx["summary"]
    return 1e3 * (sum(s["kernel_s"].values()) - s["conv_s"] - s["port_s"]) / ctx["units"]


def idle_share(ctx):
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def _geometry(ctx):
    tr, cfg = ctx["cell"].traffic, ctx["cell"].config
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    vol = 2 if tr["precision"] == "bf16" else 4
    return tr, cfg, dev, vol


def _share(nbytes, seconds):
    return None if seconds <= 0 else 100.0 * nbytes / flops.PEAK_BYTES / seconds


def lookup_roofline(ctx):
    tr, cfg, dev, vol = _geometry(ctx)
    t = kernel_s(ctx["summary"], LOOKUP)
    if t <= 0:
        return None
    per_it = flops.lookup_bytes(tr["height"], tr["width"], tr["batch"], cfg["corr_levels"],
                                cfg["corr_radius"], vol, dev)
    return _share(per_it * cfg["iters"] * ctx["units"] / tr["batch"], t)
