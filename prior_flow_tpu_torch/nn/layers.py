"""Building blocks shared by the encoders and update blocks
(counterpart of ``prior_flow_tpu/nn/layers.py``). NCHW throughout."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.instance_norm import instance_norm


def conv(in_ch: int, out_ch: int, kernel, stride: int = 1,
         padding=None) -> nn.Conv2d:
    """torch-style Conv2d with explicit zero padding (default k // 2)."""
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if padding is None:
        padding = (kernel[0] // 2, kernel[1] // 2)
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding)


class InstanceNorm(nn.Module):
    """Affine-free per-sample, per-channel norm (torch InstanceNorm2d),
    eps 1e-5, one-pass f32 statistics clamped at 0. On CUDA the forward's
    statistics and the backward's two sums come from the instance-norm sums
    kernel (``ops/kernels/instance_norm.py::InstanceNormFunction``)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return instance_norm(x, self.eps)


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d with frozen running statistics (the reference always
    freezes BN). Holds exactly weight, bias, running_mean, running_var, the
    keys the checkpoint export writes. Computes in f32 as
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``, the order Flax's
    BatchNorm uses, and returns x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        view = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(view)) * mul.view(view) \
            + self.bias.view(view)
        return y.to(x.dtype)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator):
    """Elementwise dropout at rate ``p`` drawn from ``generator``: each
    element kept with probability 1 - p and scaled by 1 / (1 - p), the
    rest zero (flax ``nn.Dropout``'s rule, ``select(keep, x / (1 - p),
    0)``)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def make_norm(kind: str, features: int) -> nn.Module:
    """'instance' or 'batch' (frozen), the two norms PriOr-RAFT uses."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return FrozenBatchNorm(features)
    raise ValueError(f"norm kind {kind!r} is not ported")
