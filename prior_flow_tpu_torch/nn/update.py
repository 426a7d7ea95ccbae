"""ConvGRU update blocks and motion encoders (counterpart of
``prior_flow_tpu/nn/update.py``): PriOr-RAFT's and RAFT's
``BasicUpdateBlock``, the ODDC ``BasicMultiUpdateBlock``, and the legacy
``SmallUpdateBlock`` of ``RAFT(small=True)``. Channel orders inside every
concatenation follow the reference exactly. NCHW throughout."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .layers import conv

CORR_PLANES = 4 * 9 ** 2  # corr_levels * (2 * radius + 1) ** 2


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv(input_dim, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, 2, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def _gru_pass(h, x, convz, convr, convq):
    """One GRU update of h by x through the three gate convs."""
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(convz(hx))
    r = torch.sigmoid(convr(hx))
    q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


class ConvGRU(nn.Module):
    """One-pass GRU with 3x3 convs (``prior_flow_tpu/nn/update.py:37``)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        self.convz = conv(cin, hidden_dim, 3)
        self.convr = conv(cin, hidden_dim, 3)
        self.convq = conv(cin, hidden_dim, 3)

    def forward(self, h, x):
        return _gru_pass(h, x, self.convz, self.convr, self.convq)


class SepConvGRU(nn.Module):
    """Two-pass GRU, (1, 5) then (5, 1) convs."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for p, (k, pad) in (("1", ((1, 5), (0, 2))), ("2", ((5, 1), (2, 0)))):
            for g in ("z", "r", "q"):
                setattr(self, f"conv{g}{p}", conv(cin, hidden_dim, k,
                                                  padding=pad))

    def forward(self, h, x):
        h = _gru_pass(h, x, self.convz1, self.convr1, self.convq1)
        return _gru_pass(h, x, self.convz2, self.convr2, self.convq2)


class SmallMotionEncoder(nn.Module):
    """Legacy {corr, flow} -> 82-channel motion feature
    (``prior_flow_tpu/nn/update.py:82``)."""

    def __init__(self, corr_planes: int = CORR_PLANES):
        super().__init__()
        self.convc1 = conv(corr_planes, 96, 1, padding=0)
        self.convf1 = conv(2, 64, 7, padding=3)
        self.convf2 = conv(64, 32, 3)
        self.conv = conv(128, 80, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMotionEncoder(nn.Module):
    """{corr, flow} -> 128-channel motion feature (branch B)."""

    def __init__(self, corr_planes: int = CORR_PLANES):
        super().__init__()
        self.convc1 = conv(corr_planes, 256, 1, padding=0)
        self.convc2 = conv(256, 192, 3)
        self.convf1 = conv(2, 128, 7, padding=3)
        self.convf2 = conv(128, 64, 3)
        self.conv = conv(64 + 192, 128 - 2, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMultiMotionEncoder(nn.Module):
    """ODDC motion encoder fusing {corr_A, flow_A, flow_B->A, flaw_A,
    flaw_B->A} (``prior_flow_tpu/nn/update.py:130``)."""

    def __init__(self, corr_planes: int = CORR_PLANES):
        super().__init__()
        self.convc1_A = conv(corr_planes, 256, 1, padding=0)
        self.convc2_A = conv(256, 128, 3)
        self.convf1_A = conv(2, 128, 7, padding=3)
        self.convf2_A = conv(128, 64, 3)
        self.convf1_B = conv(2, 128, 7, padding=3)
        self.convf2_B = conv(128, 64, 3)
        self.conv_conf1 = conv(8, 32, 3)
        self.conv_conf2 = conv(32, 16, 3)
        self.conv_A = conv(128 + 64 + 64 + 16, 128 - 4, 3)

    def forward(self, flow_A, corr_A, flaw_A, flow_B_A, flaw_B_A):
        cor_A = F.relu(self.convc2_A(F.relu(self.convc1_A(corr_A))))
        flo_A = F.relu(self.convf2_A(F.relu(self.convf1_A(flow_A))))
        flo_B = F.relu(self.convf2_B(F.relu(self.convf1_B(flow_B_A))))
        conf = F.relu(self.conv_conf1(torch.cat([flaw_A, flaw_B_A], dim=1)))
        conf = F.relu(self.conv_conf2(conf))
        out = F.relu(self.conv_A(torch.cat([cor_A, flo_A, flo_B, conf], dim=1)))
        return torch.cat([out, flow_A, flow_B_A], dim=1)


class _UpdateHeads(nn.Module):
    """SepConvGRU, flow head and upsample-mask head shared by both update
    blocks. The mask head runs only when asked for (``with_mask``)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.gru = SepConvGRU(hidden_dim=hidden_dim, input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(conv(hidden_dim, 256, 3), nn.ReLU(),
                                  conv(256, 64 * 9, 1, padding=0))

    def _heads(self, net, inp, motion, with_mask: bool):
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net) if with_mask else None
        return net, mask, delta_flow


class BasicUpdateBlock(_UpdateHeads):
    """Branch-B update: motion encoder -> SepConvGRU -> flow and mask
    heads (``prior_flow_tpu/nn/update.py:156``)."""

    def __init__(self, hidden_dim: int = 128, corr_planes: int = CORR_PLANES):
        super().__init__(hidden_dim)
        self.encoder = BasicMotionEncoder(corr_planes)

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        return self._heads(net, inp, self.encoder(flow, corr), with_mask)


class BasicMultiUpdateBlock(_UpdateHeads):
    """ODDC (branch-A) update block (``prior_flow_tpu/nn/update.py:174``)."""

    def __init__(self, hidden_dim: int = 128, corr_planes: int = CORR_PLANES):
        super().__init__(hidden_dim)
        self.encoder = BasicMultiMotionEncoder(corr_planes)

    def forward(self, net, inp, flow_A, corr_A, flaw_A, flow_B_A, flaw_B_A,
                with_mask: bool = True):
        motion = self.encoder(flow_A, corr_A, flaw_A, flow_B_A, flaw_B_A)
        return self._heads(net, inp, motion, with_mask)


class SmallUpdateBlock(nn.Module):
    """Legacy small update block (``prior_flow_tpu/nn/update.py:98``):
    ``SmallMotionEncoder``, a ``ConvGRU`` on the context and motion
    features (64 + 82 channels), a 128-wide flow head, no mask head: the
    mask it returns is None whatever ``with_mask`` asks."""

    def __init__(self, hidden_dim: int = 96, corr_planes: int = CORR_PLANES):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden_dim, input_dim=82 + 64)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=128)

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)
