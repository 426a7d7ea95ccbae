"""Feature / context encoders (counterpart of
``prior_flow_tpu/nn/encoder.py``), with the reference's attribute names so
state dicts map one to one: ``BasicEncoder`` of ``ResidualBlock``s
(PriOr-RAFT and RAFT), and the legacy ``SmallEncoder`` of
``BottleneckBlock``s (``RAFT(small=True)``). ``use_running_average=False``
turns the 'batch' norms to batch statistics (``nn.layers.BatchNorm``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .layers import conv, dropout, make_norm


class ResidualBlock(nn.Module):
    """Two 3x3 convs plus a strided 1x1 downsample when stride > 1. As in
    the reference, ``norm3`` is registered a second time as
    ``downsample.1``, so the state dict carries both names."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1, use_running_average: bool = True):
        super().__init__()
        norm = lambda: make_norm(norm_fn, planes,
                                 use_running_average=use_running_average)
        self.conv1 = conv(in_planes, planes, 3, stride=stride)
        self.conv2 = conv(planes, planes, 3)
        self.norm1 = norm()
        self.norm2 = norm()
        if stride != 1:
            self.norm3 = norm()
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride=stride, padding=0),
                self.norm3)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """Legacy 1-3-1 bottleneck (``prior_flow_tpu/nn/encoder.py:48``): 1x1 to
    planes // 4, 3x3 (strided), 1x1 to planes, each normed; a strided 1x1
    downsample normed by ``norm4``, registered a second time as
    ``downsample.1``. With 'group', ``norm1`` / ``norm2`` take planes // 8
    groups of the planes // 4 channels, ``norm3`` / ``norm4`` planes // 8
    groups of planes."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1, use_running_average: bool = True):
        super().__init__()
        q = planes // 4
        norm = lambda c, groups=None: make_norm(
            norm_fn, c, num_groups=groups,
            use_running_average=use_running_average)
        self.conv1 = conv(in_planes, q, 1, padding=0)
        self.conv2 = conv(q, q, 3, stride=stride)
        self.conv3 = conv(q, planes, 1, padding=0)
        self.norm1 = norm(q, planes // 8)
        self.norm2 = norm(q, planes // 8)
        self.norm3 = norm(planes)
        if stride != 1:
            self.norm4 = norm(planes)
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride=stride, padding=0),
                self.norm4)
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = F.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class _Encoder(nn.Module):
    """7x7/2 stem (its 'group' norm in 8 groups), three stages of two
    ``block``s and a 1x1 head: stride 8. A list input is concatenated on
    the batch axis, encoded in one pass and split back. NCHW in and out.
    Given a ``generator`` (or a ``layers.RankDraws``, whose draws are the
    global batch's), dropout at rate ``dropout`` follows the head (the
    training forward, ``prior_flow_tpu/nn/encoder.py:115-116``); without
    one the encoder is deterministic."""

    def __init__(self, block, stem: int, stages, output_dim: int,
                 norm_fn: str, dropout: float, use_running_average: bool):
        super().__init__()
        self.dropout = dropout
        self.conv1 = conv(3, stem, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, stem, num_groups=8,
                               use_running_average=use_running_average)
        for i, (inp, out, stride) in enumerate(stages, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                block(inp, out, norm_fn, stride, use_running_average),
                block(out, out, norm_fn, 1, use_running_average)))
        self.conv2 = conv(stages[-1][1], output_dim, 1, padding=0)

    def forward(self, x, generator=None):
        is_list = isinstance(x, (tuple, list))
        views = len(x) if is_list else 1
        if is_list:
            batch_dim = x[0].shape[0]
            x = torch.cat(list(x), dim=0)
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        if generator is not None and self.dropout > 0:
            x = dropout(x, self.dropout, generator, views)
        if is_list:
            return tuple(torch.split(x, batch_dim, dim=0))
        return x


class BasicEncoder(_Encoder):
    """64-channel stem, stages of ``ResidualBlock``s (64, 96/2, 128/2)
    (``prior_flow_tpu/nn/encoder.py:24-121``)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0, use_running_average: bool = True):
        super().__init__(ResidualBlock, 64,
                         [(64, 64, 1), (64, 96, 2), (96, 128, 2)],
                         output_dim, norm_fn, dropout, use_running_average)


class SmallEncoder(_Encoder):
    """Legacy small encoder (``prior_flow_tpu/nn/encoder.py:124``):
    32-channel stem, stages of ``BottleneckBlock``s (32, 64/2, 96/2)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0, use_running_average: bool = True):
        super().__init__(BottleneckBlock, 32,
                         [(32, 32, 1), (32, 64, 2), (64, 96, 2)],
                         output_dim, norm_fn, dropout, use_running_average)
