"""Padding to stride-8 shapes and the warm-start splat (counterpart of
``prior_flow_tpu/utils/padder.py``).

``InputPadder`` pads channels-last ``(..., H, W, C)`` tensors by edge
replication to the next multiple of 8: ``sintel`` mode centres the pad,
``kitti`` pads at the bottom only. It indexes rows and columns with
clamped indices, so it works on any device and dtype and copies values
exactly (``F.pad(mode="replicate")`` wants channels first).
``forward_interpolate`` is the scipy nearest-neighbour forward splat of the
reference's sequence warm start, a host function on numpy.
"""

from __future__ import annotations

import numpy as np
import torch


class InputPadder:
    def __init__(self, dims, mode: str = "sintel", multiple: int = 8):
        self.ht, self.wd = dims[-3], dims[-2]
        m = multiple
        pad_ht = (((self.ht // m) + 1) * m - self.ht) % m
        pad_wd = (((self.wd // m) + 1) * m - self.wd) % m
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def _pad_one(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        if not (l or r or t or b):
            return x
        H, W = x.shape[-3], x.shape[-2]
        rows = torch.arange(-t, H + b, device=x.device).clamp(0, H - 1)
        cols = torch.arange(-l, W + r, device=x.device).clamp(0, W - 1)
        return x.index_select(-3, rows).index_select(-2, cols)

    def pad(self, *inputs):
        out = [self._pad_one(x) for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x):
        ht, wd = x.shape[-3], x.shape[-2]
        l, r, t, b = self._pad
        return x[..., t:ht - b, l:wd - r, :]


def forward_interpolate(flow) -> np.ndarray:
    """Forward-splat a flow field to the next frame by nearest-neighbour
    scattered interpolation, for the sequence warm start
    (``prior_flow_tpu/utils/padder.py:40``).

    flow: (H, W, 2) numpy array or tensor -> (H, W, 2) numpy float32.
    """
    from scipy import interpolate as scipy_interpolate

    if isinstance(flow, torch.Tensor):
        flow = flow.detach().cpu().numpy()
    flow = np.asarray(flow)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    flow_x = scipy_interpolate.griddata(
        (x1[valid], y1[valid]), dxf[valid], (x0, y0), method="nearest",
        fill_value=0)
    flow_y = scipy_interpolate.griddata(
        (x1[valid], y1[valid]), dyf[valid], (x0, y0), method="nearest",
        fill_value=0)
    return np.stack([flow_x, flow_y], axis=-1).astype(np.float32)
