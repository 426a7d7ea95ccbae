"""The numbers that decide ``correct``, each held to its cell's limit.

Every number is taken over the checked pairs, per pair, and the worst
pair's is the number: the end-point distance in pixels between the
program's flow and the reference's at each pixel of the pair, and of
those distances

- ``flow_epe_median_px``, their median: the whole field, steady from seed
  to seed (the program's rounding moves every pixel a little);
- ``flow_epe_q90_px``, their 90th percentile: a fault confined to a tenth
  of the frame or more (a seam, the poles, one branch's rows) that
  leaves the median where it was.

In pixels, not over the reference's flow magnitude: the seeded weights
give flows of some tens of pixels whose size varies from seed to seed,
while the rounding's distance in pixels does not, so a ratio to the
magnitude swings with the seed and brings the program's worst seed near
the lower-precision control's best.
"""

from __future__ import annotations

import math

import torch

QUANTILES = {"flow_epe_median_px": 0.5, "flow_epe_q90_px": 0.9}


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def flow_numbers(prog: torch.Tensor, ref: torch.Tensor) -> dict:
    """The worst pair's quantiles of (B, H, W, 2) flows' end-point distance."""
    d = (prog.float() - ref.float()).norm(dim=-1).flatten(1)
    if not torch.isfinite(d).all():
        return {k: math.inf for k in QUANTILES}
    return {k: _finite(torch.quantile(d, q, dim=1).max().item()) for k, q in QUANTILES.items()}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limit of the cell met by a
    finite number."""
    rows = [(k, numbers.get(k, math.inf), lim) for k, lim in sorted(limits.items())]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
