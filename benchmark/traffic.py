"""The one generator of every traffic mix: panorama pairs from a seed.

A pair is two equirectangular frames related by a smooth flow: frame 2 is
a random texture (octaves of upsampled noise, brightest octave first),
frame 1 reads it at x + flow(x) (x wrapping around, y clamped), so the
flow from frame 1 to frame 2 is ``flow``. The flow is a few random
vectors per 64x64 block, upsampled bicubically, with the RMS magnitude
the mix's ``flow_rms_px`` at its width. Everything is drawn on the
device from one generator keyed by (seed, stream), in large calls, then
the frames are moved to pinned host memory in ``uint8``, as a loader
hands them over.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

FRAMES = 1       # the generator stream of inference frames


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (2 ** 63))


def _texture(n, H, W, gen, device):
    out = torch.zeros(n, 3, H, W, device=device)
    for k in range(5):
        h, w = max(H >> (6 - k), 1), max(W >> (6 - k), 1)
        noise = torch.randn(n, 3, h, w, generator=gen, device=device)
        out += 0.6 ** k * F.interpolate(noise, size=(H, W), mode="bilinear",
                                        align_corners=False)
    lo = out.amin(dim=(1, 2, 3), keepdim=True)
    hi = out.amax(dim=(1, 2, 3), keepdim=True)
    return (out - lo) / (hi - lo) * 255.0


def _flow(n, H, W, rms_px, gen, device):
    coarse = torch.randn(n, 2, max(H // 64, 2), max(W // 64, 2), generator=gen, device=device)
    f = F.interpolate(coarse, size=(H, W), mode="bicubic", align_corners=False)
    f = f * (rms_px / f.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt())
    return f.permute(0, 2, 3, 1).contiguous()


def _warp(tex, flow):
    """tex (n, 3, H, W) read at x + flow, x wrapped, y clamped."""
    n, _, H, W = tex.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=tex.device, dtype=torch.float32),
                            torch.arange(W, device=tex.device, dtype=torch.float32),
                            indexing="ij")
    x = torch.remainder(xs + flow[..., 0], W)
    y = (ys + flow[..., 1]).clamp(0, H - 1)
    # one column of wrap so that x in (W-1, W) blends with column 0
    padded = torch.cat([tex, tex[..., :1]], dim=3)
    grid = torch.stack([2.0 * x / W - 1.0, 2.0 * y / (H - 1) - 1.0], dim=-1)
    return F.grid_sample(padded, grid, mode="bilinear", align_corners=True)


def make_pairs(n, H, W, rms_px, seed, stream, device, chunk=4):
    """``n`` pairs (image1, image2), uint8 (n, H, W, 3), pinned on the host
    when ``device`` is a card."""
    gen = generator(seed, stream, device)
    pin = torch.device(device).type == "cuda"
    im1, im2 = (torch.empty((n, H, W, 3), dtype=torch.uint8, pin_memory=pin) for _ in range(2))
    for a in range(0, n, chunk):
        k = min(chunk, n - a)
        tex = _texture(k, H, W, gen, device)
        f = _flow(k, H, W, rms_px, gen, device)
        first = _warp(tex, f)
        im1[a:a + k].copy_(first.permute(0, 2, 3, 1).round().clamp(0, 255).to(torch.uint8))
        im2[a:a + k].copy_(tex.permute(0, 2, 3, 1).round().clamp(0, 255).to(torch.uint8))
    return im1, im2


def flow_rms(traffic) -> float:
    """The mix's RMS flow magnitude in pixels at its own width."""
    return traffic["flow_rms_px"] * traffic["width"] / traffic["flow_rms_width"]
