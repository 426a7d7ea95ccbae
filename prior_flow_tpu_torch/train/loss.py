"""Latitude-weighted sequence loss for dual-branch training (counterpart
of ``prior_flow_tpu/train/loss.py``).

Per-iteration L1 error weighted by gamma^(N-i-1); each pixel weighted by
the normalised cos-latitude mask and masked by validity and
||gt|| < max_flow. The loss is a SUM over pixels, not a mean, which keeps
the reference's gradient scale.
"""

from __future__ import annotations

import torch

from ..eval.metrics import spherical_mask

MAX_FLOW = 400.0


def uniform_sequence_loss(flow_preds, flow_gt, valid, gamma: float = 0.8,
                          max_flow: float = MAX_FLOW, prefix: str = ""):
    """flow_preds: (iters, B, H, W, 2); flow_gt: (B, H, W, 2); valid:
    (B, H, W). Returns (loss, metrics) with the metrics epe, 1px, 3px and
    5px of the final prediction over valid pixels, as 0-dim tensors (read
    them on the host only where needed: each read waits for the card)."""
    n, _, H, W, _ = flow_preds.shape
    weights = torch.from_numpy(spherical_mask(H, W).copy()).to(
        flow_preds.device)[None]
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)

    i = torch.arange(n, dtype=flow_preds.dtype, device=flow_preds.device)
    i_weights = gamma ** (n - i - 1.0)
    abs_err = torch.sum(torch.abs(flow_preds - flow_gt[None]), dim=-1)
    per_iter = torch.sum(abs_err * (valid * weights)[None], dim=(1, 2, 3))
    loss = torch.sum(i_weights * per_iter)

    with torch.no_grad():
        err = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
        denom = torch.clamp_min(valid.sum(), 1)
        metrics = {
            prefix + "epe": torch.where(valid, err, 0.0).sum() / denom,
            prefix + "1px": ((err < 1) & valid).sum() / denom,
            prefix + "3px": ((err < 3) & valid).sum() / denom,
            prefix + "5px": ((err < 5) & valid).sum() / denom,
        }
    return loss, metrics
