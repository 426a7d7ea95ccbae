"""Building blocks shared by the encoders and update blocks
(counterpart of ``prior_flow_tpu/nn/layers.py``). NCHW throughout."""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def _affine(x, mean, var, eps, weight, bias):
    """``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, Flax's
    ``_normalize`` order, in x's dtype. mean, var: broadcastable to x."""
    view = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * weight.view(view)
    return ((x.float() - mean) * mul + bias.view(view)).to(x.dtype)


def _fast_stats(xf, dims):
    """Flax's ``_compute_stats`` (``use_fast_variance``): the mean and the
    biased variance E[x^2] - E[x]^2, clamped at 0, over ``dims`` of the f32
    ``xf``."""
    mean = xf.mean(dim=dims)
    var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
    return mean, var


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
        return _affine(x, self.running_mean.view(view),
                       self.running_var.view(view), self.eps, self.weight,
                       self.bias)


class BatchNorm(FrozenBatchNorm):
    """BatchNorm2d on batch statistics (Flax ``nn.BatchNorm`` with
    ``use_running_average=False``, ``momentum=0.9``, eps 1e-5): every call
    normalises by the mean and the biased variance over (N, H, W) of its
    input, in f32, and updates the running statistics in place as
    ``0.9 * old + 0.1 * batch`` with that biased variance (torch's
    ``BatchNorm2d`` keeps the unbiased one). The running statistics are
    read by no call: they are what a later ``FrozenBatchNorm`` would use.
    The same four state-dict keys as ``FrozenBatchNorm``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__(num_features, eps)
        self.momentum = momentum

    def forward(self, x):
        mean, var = _fast_stats(x.float(), (0, 2, 3))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        view = (1, -1, 1, 1)
        return _affine(x, mean.view(view), var.view(view), self.eps,
                       self.weight, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm (Flax ``nn.GroupNorm``, eps 1e-5): per sample, the mean
    and biased variance of each group of ``num_channels // num_groups``
    consecutive channels over (C/G, H, W), in f32, then the per-channel
    affine; x's dtype out. Keys ``weight`` and ``bias``, as torch's."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide "
                             f"{num_channels} channels")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        N, C = x.shape[:2]
        G = self.num_groups
        mean, var = _fast_stats(x.float().reshape(N, G, -1), (2,))
        per_channel = lambda t: t.repeat_interleave(C // G, dim=1).view(
            N, C, 1, 1)
        return _affine(x, per_channel(mean), per_channel(var), self.eps,
                       self.weight, self.bias)


class RankDraws(NamedTuple):
    """A generator whose batch-shaped draws are made at the global batch
    of a data-parallel mesh of ``world`` ranks, of which this rank keeps
    its rows (``draw_rows``): every rank then draws what one process
    training on the global batch would."""

    generator: torch.Generator
    rank: int
    world: int


def draw_rows(sampler, shape, generator, device, views: int = 1):
    """``sampler(shape, generator=, device=)`` (``torch.rand`` /
    ``torch.randn``) for a tensor whose dim 0 is ``views`` blocks of batch
    rows, view-major (the encoders' concatenated views). With a
    ``RankDraws`` the draw is made for ``views`` blocks of ``world`` times
    the rows and each block's rows of this rank are kept; with a plain
    generator (or ``world == 1``) it is the plain draw."""
    if not isinstance(generator, RankDraws):
        return sampler(shape, generator=generator, device=device)
    g, rank, world = generator
    shape = tuple(shape)
    per = shape[0] // views
    full = sampler((views * world * per, *shape[1:]), generator=g,
                   device=device)
    return full.view(views, world, per, *shape[1:])[:, rank].reshape(shape)


def dropout(x: torch.Tensor, p: float, generator, views: int = 1):
    """Elementwise dropout at rate ``p`` drawn from ``generator`` (a
    ``torch.Generator`` or ``RankDraws``; ``views`` as ``draw_rows``
    reads it): each element kept with probability 1 - p and scaled by
    1 / (1 - p), the rest zero (flax ``nn.Dropout``'s rule,
    ``select(keep, x / (1 - p), 0)``)."""
    keep = draw_rows(torch.rand, x.shape, generator, x.device, views) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def make_norm(kind: str, features: int, num_groups: Optional[int] = None,
              use_running_average: bool = True) -> nn.Module:
    """The norm of the reference's ``norm_fn`` choices
    (``prior_flow_tpu/nn/layers.py:80-108``): 'instance'; 'batch', frozen
    (``FrozenBatchNorm``) or with ``use_running_average=False`` on batch
    statistics (``BatchNorm``); 'group', ``GroupNorm`` with ``num_groups``
    or features // 8 groups; 'none', the identity."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return (FrozenBatchNorm(features) if use_running_average
                else BatchNorm(features))
    if kind == "group":
        return GroupNorm(num_groups or features // 8, features)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm kind {kind!r}")
