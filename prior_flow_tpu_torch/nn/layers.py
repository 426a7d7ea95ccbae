"""Building blocks shared by the encoders and update blocks
(counterpart of ``prior_flow_tpu/nn/layers.py``). NCHW throughout.

Under a ``parallel.spatial.scope`` (height sharding) the convolutions pad
their rows with the neighbouring ranks' (``Conv2d``), the instance and
group norms sum their per-sample statistics over the real rows of the
space group, the batch-statistics BatchNorm its per-channel ones over
every rank of the global batch (also on a data-only mesh), and the
dropout draws are the whole image's (``draw_rows``); outside one nothing
changes."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kernels.instance_norm import instance_norm
from ..parallel import spatial


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state-dict keys) that, under
    a space scope, takes its input rows' halo from the ranks above and
    below (``spatial.halo_rows``) and convolves with height padding 0:
    ``padding`` rows above and ``kernel - padding - stride`` below (none
    below where that is negative), so the rank's output rows are those of
    the unsharded convolution."""

    def forward(self, x):
        space = spatial.current()
        if space is None:
            return super().forward(x)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        top, bottom = p, max(0, k - p - s)
        if top or bottom:
            x = spatial.halo_rows(x, top, bottom, dim=2, space=space)
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        (0, self.padding[1]), self.dilation, self.groups)


def conv(in_ch: int, out_ch: int, kernel, stride: int = 1,
         padding=None) -> Conv2d:
    """torch-style Conv2d with explicit zero padding (default k // 2)."""
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if padding is None:
        padding = (kernel[0] // 2, kernel[1] // 2)
    return Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding)


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


def _fast_stats(xf, dims, batch: bool = False, groups: int = 0):
    """Flax's ``_compute_stats`` (``use_fast_variance``): the mean and the
    biased variance E[x^2] - E[x]^2, clamped at 0, over ``dims`` of the f32
    NCHW ``xf`` (with ``groups``, of its (N, groups, C / groups * H * W)
    view). Under a space scope ``xf`` holds a rank's strip: the sums of x
    and x^2 over its real rows are taken in f64, added up over the space
    group (with ``batch``, over every rank of the global batch, and on a
    data-only mesh over its data ranks; ``spatial.summed``, whose backward
    sums the cotangents over the same ranks), rounded to f32 once and
    divided by the whole image's pixel count, and the moments follow in
    f32, as the instance norm's sharded sums do
    (``ops/kernels/instance_norm.py``). The variance is then the
    unsharded one's difference of two f32 moments: where the mean is
    large against the spread, that difference cancels, and variances
    taken in f64 moved the batch-statistics step's context encoder
    gradients by ~1e-3 of their norm from the unsharded step's (64x128 on
    the CPU)."""
    view = ((lambda t: t.reshape(t.shape[0], groups, -1)) if groups
            else (lambda t: t))
    space = spatial.current(batch)
    if space is None:
        xf = view(xf)
        mean = xf.mean(dim=dims)
        var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
        return mean, var
    h = xf.shape[2]
    xd = view(xf.narrow(2, 0, space.real(h)).double())
    n = (math.prod(view(xf).shape[d] for d in dims) // h * space.whole(h)
         * (space.data if batch else 1))
    s1, s2 = spatial.summed(torch.stack(
        [xd.sum(dim=dims), (xd * xd).sum(dim=dims)]), batch, space).float()
    mean = s1 / n
    return mean, torch.clamp_min(s2 / n - mean * mean, 0.0)


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
    The same four state-dict keys as ``FrozenBatchNorm``. On a mesh (a
    ``spatial.scope``: ``make_train_step(mesh=)`` enters one) the
    statistics are the global batch's, as JAX's jitted apply on a
    ``P('data', 'space')`` or ``P('data')`` batch computes them: summed
    over the real rows of the space group, and over the data ranks too on
    a mesh with a data axis (``_fast_stats``); every rank then holds the
    same running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__(num_features, eps)
        self.momentum = momentum

    def forward(self, x):
        mean, var = _fast_stats(x.float(), (0, 2, 3), batch=True)
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
    affine; x's dtype out. Keys ``weight`` and ``bias``, as torch's.
    Height-sharded, each sample's statistics are summed over the real rows
    of the space group (``_fast_stats``)."""

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
        mean, var = _fast_stats(x.float(), (2,), groups=G)
        per_channel = lambda t: t.repeat_interleave(C // G, dim=1).view(
            N, C, 1, 1)
        return _affine(x, per_channel(mean), per_channel(var), self.eps,
                       self.weight, self.bias)


class RankDraws(NamedTuple):
    """A generator whose batch-shaped draws are made at the global batch
    of a data-parallel mesh of ``world`` data ranks, of which this rank
    keeps its rows (``draw_rows``), and, on a space axis of ``space``
    ranks, at the whole image's height, of which it keeps its strip:
    every rank then draws what one process training on the global batch
    would."""

    generator: torch.Generator
    rank: int
    world: int
    space_rank: int = 0
    space: int = 1


def draw_rows(sampler, shape, generator, device, views: int = 1,
              hdim: int = 2):
    """``sampler(shape, generator=, device=)`` (``torch.rand`` /
    ``torch.randn``) for a tensor whose dim 0 is ``views`` blocks of batch
    rows, view-major (the encoders' concatenated views), and whose dim
    ``hdim`` is the image height. With a ``RankDraws`` the draw is made
    for ``views`` blocks of ``world`` times the rows, and for the whole
    image's height (``space`` strips of ``shape[hdim]`` rows, or under a
    space scope with a height, ``Space.whole`` of them, padded to the
    strips with zeros), and this rank's batch rows of each block and its
    strip are kept; with a plain generator (or one rank) it is the plain
    draw."""
    if not isinstance(generator, RankDraws):
        return sampler(shape, generator=generator, device=device)
    g, rank, world, srank, space = generator
    shape = tuple(shape)
    per = shape[0] // views
    h = shape[hdim]
    scope = spatial.current()
    full = list(shape)
    full[0] = views * world * per
    full[hdim] = h * space if scope is None else scope.whole(h)
    draw = spatial.pad_rows(sampler(tuple(full), generator=g, device=device),
                            hdim, h * space)
    draw = draw.view(views, world, per, *shape[1:hdim], space,
                     *shape[hdim:])[:, rank]
    return draw.select(hdim + 1, srank).reshape(shape)


def dropout(x: torch.Tensor, p: float, generator, views: int = 1):
    """Elementwise dropout at rate ``p`` of NCHW ``x``, drawn from
    ``generator`` (a ``torch.Generator`` or ``RankDraws``; ``views`` as
    ``draw_rows`` reads it): each element kept with probability 1 - p and
    scaled by 1 / (1 - p), the rest zero (flax ``nn.Dropout``'s rule,
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
