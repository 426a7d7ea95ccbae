"""Plain PyTorch pieces of the frozen PriOr-RAFT and RAFT references.

Written from the papers (PriOr-Flow, arXiv 2506.23897; RAFT, arXiv
2003.12039) and the reference layout of their state dicts. Every function
reads its weights from a flat ``state_dict`` by name; nothing here imports
the program under test. Images and fields are channels-last (B, H, W, C),
the networks run NCHW.

``Arith`` says in what precision the convolutions and the correlation
matmul run: ``fp32`` (TF32 off, the reference) or ``fp8`` (operands
quantised to float8 e4m3 with one scale per tensor, the arithmetic in
f32), the control of the bf16 cells that their correctness limits are
set against.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.nn import functional as F

ARITHS = ("fp32", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """Full f32 convolutions and matmuls (TF32 off, through torch's
    ``fp32_precision`` flags), the caller's flags put back."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    saved = [f.fp32_precision for f in flags]
    try:
        for f in flags:
            f.fp32_precision = "ieee"
        yield
    finally:
        for f, v in zip(flags, saved):
            f.fp32_precision = v


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 and back, scaled so its largest magnitude
    maps to the format's largest."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = E4M3_MAX / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale)


class Arith:
    """The precision of the convolutions and the correlation matmul."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ARITHS:
            raise ValueError(f"arith must be one of {ARITHS}, got {kind!r}")
        self.kind = kind

    def _operands(self, *ts):
        if self.kind == "fp8":
            return [_fp8(t) for t in ts]
        return [t.float() for t in ts]

    def conv(self, x, w, b, stride=1, padding=0):
        xq, wq = self._operands(x, w)
        bq = b.to(xq.dtype)
        return F.conv2d(xq, wq, bq, stride, padding).float()

    def matmul(self, a, b):
        aq, bq = self._operands(a, b)
        return torch.matmul(aq, bq).float()


# -- samplers (pixel coordinates, align-corners bilinear) ---------------------

def _gather(img, ix, iy):
    """img (B, H, W, C) at integer (B, N) indices -> (B, N, C)."""
    B, H, W, C = img.shape
    idx = (iy * W + ix).unsqueeze(-1).expand(-1, -1, C)
    return torch.gather(img.reshape(B, H * W, C), 1, idx)


def bilinear(img, coords, wrap_x: bool = False):
    """Bilinear read of img (B, H, W, C) at pixel coords (B, ..., 2), [x, y];
    a corner outside [0, W-1] x [0, H-1] reads zero. With ``wrap_x`` x is
    first taken mod W (a corner at x = W still reads zero)."""
    B, H, W, C = img.shape
    lead = coords.shape[:-1]
    c = coords.reshape(B, -1, 2).float()
    x, y = c[..., 0], c[..., 1]
    if wrap_x:
        x = torch.remainder(x, W)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    out = 0.0
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            cx, cy = x0 + dx, y0 + dy
            ok = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
            v = _gather(img, cx.clamp(0, W - 1).long(), cy.clamp(0, H - 1).long())
            out = out + v * (wx * wy * ok).unsqueeze(-1)
    return out.reshape(*lead, C)


def wrap_grid_sample(img, grid, is_grid: bool = False):
    """Bilinear read with x wrapping around (x1 = (x0 + 1) mod W) and y
    clamped to the image; with ``is_grid`` the payload is itself a pixel
    grid, and the other corners' x is moved into the first corner's branch
    of the +-W seam before blending."""
    B, H, W, C = img.shape
    lead = grid.shape[:-1]
    g = grid.reshape(B, -1, 2).float()
    x = torch.remainder(g[..., 0], W)
    y = g[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0 = x0f.long() % W
    x1 = (x0f.long() + 1) % W
    y0 = y0f.clamp(0, H - 1).long()
    y1 = (y0f + 1).clamp(0, H - 1).long()
    a, b, c, d = (_gather(img, x0, y0), _gather(img, x0, y1),
                  _gather(img, x1, y0), _gather(img, x1, y1))
    if is_grid:
        def seam(v):
            m = a[..., 0] + torch.remainder(v[..., 0] - a[..., 0] + W / 2.0, W) - W / 2.0
            return torch.cat([m.unsqueeze(-1), v[..., 1:]], dim=-1)
        b, c, d = seam(b), seam(c), seam(d)
    out = (((1 - fx) * (1 - fy)).unsqueeze(-1) * a + ((1 - fx) * fy).unsqueeze(-1) * b
           + (fx * (1 - fy)).unsqueeze(-1) * c + (fx * fy).unsqueeze(-1) * d)
    return out.reshape(*lead, C)


def identity(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) pixel grid, [..., 0] = x."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def window(radius: int, device) -> torch.Tensor:
    """(K, 2) offsets of a (2r+1)^2 window: tap i*(2r+1) + j is at x-offset
    i - r, y-offset j - r."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    n = 2 * radius + 1
    return torch.stack([d.repeat_interleave(n), d.repeat(n)], dim=-1)


# -- networks ------------------------------------------------------------------

def conv(sd, name, x, ar: Arith, stride=1, padding=None):
    w = sd[name + ".weight"]
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    return ar.conv(x, w, sd[name + ".bias"], stride, padding)


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def frozen_batch_norm(sd, name, x, eps=1e-5):
    v = (1, -1, 1, 1)
    scale = sd[name + ".weight"].view(v) / torch.sqrt(sd[name + ".running_var"].view(v) + eps)
    return (x - sd[name + ".running_mean"].view(v)) * scale + sd[name + ".bias"].view(v)


def _norm(kind, sd, name, x):
    return instance_norm(x) if kind == "instance" else frozen_batch_norm(sd, name, x)


def residual_block(sd, p, x, kind, stride, ar):
    y = F.relu(_norm(kind, sd, p + ".norm1", conv(sd, p + ".conv1", x, ar, stride)))
    y = F.relu(_norm(kind, sd, p + ".norm2", conv(sd, p + ".conv2", y, ar)))
    if stride != 1:
        x = _norm(kind, sd, p + ".norm3",
                  conv(sd, p + ".downsample.0", x, ar, stride, 0))
    return F.relu(x + y)


ENCODER_STAGES = ((64, 64, 1), (64, 96, 2), (96, 128, 2))


def basic_encoder(sd, p, x, kind, ar):
    """7x7/2 stem, three stages of two residual blocks, 1x1 head: stride 8.
    x: NCHW in [-1, 1]."""
    x = F.relu(_norm(kind, sd, p + ".norm1", conv(sd, p + ".conv1", x, ar, 2, 3)))
    for i, (_, _, stride) in enumerate(ENCODER_STAGES, start=1):
        x = residual_block(sd, f"{p}.layer{i}.0", x, kind, stride, ar)
        x = residual_block(sd, f"{p}.layer{i}.1", x, kind, 1, ar)
    return conv(sd, p + ".conv2", x, ar, 1, 0)


def sep_conv_gru(sd, p, h, x, ar):
    for k in ("1", "2"):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(conv(sd, f"{p}.convz{k}", hx, ar))
        r = torch.sigmoid(conv(sd, f"{p}.convr{k}", hx, ar))
        q = torch.tanh(conv(sd, f"{p}.convq{k}", torch.cat([r * h, x], dim=1), ar))
        h = (1 - z) * h + z * q
    return h


def update_heads(sd, p, net, inp, motion, with_mask, ar):
    net = sep_conv_gru(sd, p + ".gru", net, torch.cat([inp, motion], dim=1), ar)
    delta = conv(sd, p + ".flow_head.conv2",
                 F.relu(conv(sd, p + ".flow_head.conv1", net, ar)), ar)
    mask = None
    if with_mask:
        mask = 0.25 * conv(sd, p + ".mask.2",
                           F.relu(conv(sd, p + ".mask.0", net, ar)), ar, 1, 0)
    return net, mask, delta


def basic_motion(sd, p, flow, corr, ar):
    cor = F.relu(conv(sd, p + ".convc2", F.relu(conv(sd, p + ".convc1", corr, ar, 1, 0)), ar))
    flo = F.relu(conv(sd, p + ".convf2", F.relu(conv(sd, p + ".convf1", flow, ar)), ar))
    out = F.relu(conv(sd, p + ".conv", torch.cat([cor, flo], dim=1), ar))
    return torch.cat([out, flow], dim=1)


def basic_update(sd, p, net, inp, corr, flow, with_mask, ar):
    return update_heads(sd, p, net, inp, basic_motion(sd, p + ".encoder", flow, corr, ar),
                        with_mask, ar)


def upsample_convex(flow, mask):
    """flow (B, h, w, 2), mask (B, h, w, 576) as (9, 8, 8) -> (B, 8h, 8w, 2):
    each fine pixel a softmax-weighted mix of its coarse 3x3 neighbourhood
    (zero beyond the border) of 8x the flow."""
    B, h, w, _ = flow.shape
    m = torch.softmax(mask.permute(0, 3, 1, 2).reshape(B, 1, 9, 8, 8, h, w), dim=2)
    nb = F.unfold(8.0 * flow.permute(0, 3, 1, 2), [3, 3], padding=1)
    nb = nb.reshape(B, 2, 9, 1, 1, h, w)
    up = (m * nb).sum(dim=2)                              # (B, 2, 8, 8, h, w)
    return up.permute(0, 4, 2, 5, 3, 1).reshape(B, 8 * h, 8 * w, 2)


# -- correlation ---------------------------------------------------------------

def correlation_pyramid(f1, f2, levels, ar):
    """All-pairs correlation of channels-last f1 (B, h, w, C) against f2,
    over sqrt(C), average-pooled over the target axes: per level
    (B, h*w, Hl, Wl) f32."""
    B, h, w, C = f1.shape
    H2, W2 = f2.shape[1:3]
    vol = ar.matmul(f1.reshape(B, h * w, C),
                    f2.reshape(B, H2 * W2, C).transpose(1, 2)) / math.sqrt(C)
    pyr = [vol.reshape(B, h * w, H2, W2)]
    for _ in range(levels - 1):
        v = pyr[-1]
        Hl, Wl = v.shape[2] // 2 * 2, v.shape[3] // 2 * 2
        v = v[:, :, :Hl, :Wl].reshape(B, h * w, Hl // 2, 2, Wl // 2, 2).mean(dim=(3, 5))
        pyr.append(v)
    return pyr


def sample_per_query(vol, coords, wrap_x):
    """vol (B, Q, Hl, Wl) read at per-query coords (B, Q, K, 2) -> (B, Q, K)."""
    B, Q, Hl, Wl = vol.shape
    K = coords.shape[2]
    out = bilinear(vol.reshape(B * Q, Hl, Wl, 1), coords.reshape(B * Q, K, 2), wrap_x)
    return out.reshape(B, Q, K)
