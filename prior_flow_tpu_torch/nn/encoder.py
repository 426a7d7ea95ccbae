"""Feature / context encoders (counterpart of
``prior_flow_tpu/nn/encoder.py:24-121``), with the reference's attribute
names so state dicts map one to one."""

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
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride=stride)
        self.conv2 = conv(planes, planes, 3)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes)
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


class BasicEncoder(nn.Module):
    """7x7/2 stem, three stages of two ResidualBlocks (64, 96/2, 128/2) and a
    1x1 head: stride 8. A list input is concatenated on the batch axis,
    encoded in one pass and split back. NCHW in and out. Given a
    ``generator``, dropout at rate ``dropout`` follows the head (the
    training forward, ``prior_flow_tpu/nn/encoder.py:115-116``); without
    one the encoder is deterministic."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv1 = conv(3, 64, 7, stride=2, padding=3)
        self.norm1 = make_norm(norm_fn, 64)
        stages = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (inp, out, stride) in enumerate(stages, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(inp, out, norm_fn, stride=stride),
                ResidualBlock(out, out, norm_fn, stride=1)))
        self.conv2 = conv(128, output_dim, 1, padding=0)

    def forward(self, x, generator=None):
        is_list = isinstance(x, (tuple, list))
        if is_list:
            batch_dim = x[0].shape[0]
            x = torch.cat(list(x), dim=0)
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(x)
        if generator is not None and self.dropout > 0:
            x = dropout(x, self.dropout, generator)
        if is_list:
            return tuple(torch.split(x, batch_dim, dim=0))
        return x
