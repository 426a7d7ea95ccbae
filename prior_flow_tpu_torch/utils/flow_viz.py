"""Optical-flow visualisation (counterpart of
``prior_flow_tpu/utils/flow_viz.py``): the Middlebury colour wheel, the
panoramic colouring by spherical arc length, PanoFlow-style alpha scaling,
and the side-by-side webp with a warped reconstruction. The colour maps
are numpy; ``save_gif`` imports ``cv2`` and ``PIL`` when it is called.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def make_colorwheel() -> np.ndarray:
    """(55, 3) Middlebury colour wheel
    (``prior_flow_tpu/utils/flow_viz.py:18``)."""
    transitions = [("RY", 15), ("YG", 6), ("GC", 4), ("CB", 11), ("BM", 13),
                   ("MR", 6)]
    ncols = sum(n for _, n in transitions)
    wheel = np.zeros((ncols, 3))
    col = 0
    for name, n in transitions:
        ramp = np.floor(255 * np.arange(n) / n)
        if name == "RY":
            wheel[col:col + n, 0] = 255
            wheel[col:col + n, 1] = ramp
        elif name == "YG":
            wheel[col:col + n, 0] = 255 - ramp
            wheel[col:col + n, 1] = 255
        elif name == "GC":
            wheel[col:col + n, 1] = 255
            wheel[col:col + n, 2] = ramp
        elif name == "CB":
            wheel[col:col + n, 1] = 255 - ramp
            wheel[col:col + n, 2] = 255
        elif name == "BM":
            wheel[col:col + n, 2] = 255
            wheel[col:col + n, 0] = ramp
        elif name == "MR":
            wheel[col:col + n, 2] = 255 - ramp
            wheel[col:col + n, 0] = 255
        col += n
    return wheel


def _colors_from_rad_angle(rad, a, convert_to_bgr=False):
    """Shared colour-wheel interpolation
    (``prior_flow_tpu/utils/flow_viz.py:49``)."""
    wheel = make_colorwheel()
    ncols = wheel.shape[0]
    img = np.zeros(rad.shape + (3,), np.uint8)
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    inrange = rad <= 1
    for i in range(3):
        col0 = wheel[k0, i] / 255.0
        col1 = wheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(inrange, 1 - rad * (1 - col), col * 0.75)
        ch = 2 - i if convert_to_bgr else i
        img[..., ch] = np.floor(255 * col)
    return img


def flow_uv_to_colors(u, v, convert_to_bgr=False):
    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    return _colors_from_rad_angle(rad, a, convert_to_bgr)


def flow_to_image(flow_uv, clip_flow=None, convert_to_bgr=False):
    """(H, W, 2) planar-magnitude colouring
    (``prior_flow_tpu/utils/flow_viz.py:75``)."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad_max = np.sqrt(u ** 2 + v ** 2).max()
    eps = 1e-5
    return flow_uv_to_colors(u / (rad_max + eps), v / (rad_max + eps),
                             convert_to_bgr)


def omniflow_to_image(flow, clip_flow=None, convert_to_bgr=False):
    """(H, W, 2) or (2, H, W) panoramic colouring: hue = flow angle,
    magnitude = spherical arc length clipped at the 95th percentile
    (``prior_flow_tpu/utils/flow_viz.py:87``). The arc length is computed
    on the CPU."""
    from ..eval.metrics import spherical_flow_magnitude

    flow = _numpy(flow)
    if flow.ndim == 3 and flow.shape[0] == 2:  # channels-first input
        flow = np.transpose(flow, (1, 2, 0))
    assert flow.ndim == 3 and flow.shape[2] == 2
    if clip_flow is not None:
        flow = np.clip(flow, 0, clip_flow)
    sd = spherical_flow_magnitude(
        torch.from_numpy(np.ascontiguousarray(flow, np.float32))[None])
    sd = sd[0].numpy()
    clip_sd = np.sort(sd, axis=None)[int(0.95 * sd.size)]
    sd = np.clip(sd, 0, clip_sd)

    u, v = flow[..., 0], flow[..., 1]
    a = np.arctan2(-v, -u) / np.pi
    rad = sd / (sd.max() + 1e-5)
    return _colors_from_rad_angle(rad, a, convert_to_bgr)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def better_flow_to_image(flow_uv, alpha=0.5, max_flow=724, clip_flow=None,
                         convert_to_bgr=False):
    """PanoFlow-style alpha-scaled colouring for extreme-distance flow
    (``prior_flow_tpu/utils/flow_viz.py:110``)."""
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad = np.sqrt(u ** 2 + v ** 2)
    scale = np.power(rad / max_flow, alpha) / (max_flow + 1e-5)
    return flow_uv_to_colors(scale * u, scale * v, convert_to_bgr)


def save_gif(image1, image2, flow_est, filename, out_folder):
    """Side-by-side webp animation: [image2 | warped reconstruction | flow
    colour map] against [image1 | image1 | flow]
    (``prior_flow_tpu/utils/flow_viz.py:123``). image1/image2: (H, W, 3)
    uint8-range arrays; flow_est: (H, W, 2). Needs cv2 (the captions) and
    PIL (the webp writer)."""
    try:
        import cv2
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"save_gif needs cv2 and PIL: {e}") from e

    from ..ops.warp import cycle_warp

    image1 = _numpy(image1).astype(np.uint8)
    image2 = _numpy(image2).astype(np.uint8)
    flow_est = _numpy(flow_est)

    font = cv2.FONT_HERSHEY_DUPLEX
    top_left = (10, 30)
    bottom_left = (10, image1.shape[0] - 10)
    scale_, color, thick, ltype = 1, (0, 0, 0), 1, cv2.LINE_AA

    flow_vis = omniflow_to_image(flow_est)
    flow_vis = cv2.putText(flow_vis, "flow_est", top_left, font, scale_,
                           color, thick, ltype)
    max_u = np.abs(flow_est[..., 0]).max()
    max_v = np.abs(flow_est[..., 1]).max()
    flow_vis = cv2.putText(flow_vis, f"max_u={max_u:.2f}", bottom_left, font,
                           scale_, color, thick, ltype)
    text = f"max_v={max_v:.2f}"
    (tw, _), _ = cv2.getTextSize(text, font, scale_, thick)
    flow_vis = cv2.putText(flow_vis, text,
                           (image1.shape[1] - 10 - tw, image1.shape[0] - 10),
                           font, scale_, color, thick, ltype)

    flow_t = torch.from_numpy(np.ascontiguousarray(flow_est, np.float32))
    recon = cycle_warp(torch.from_numpy(image2.astype(np.float32))[None],
                       flow_t[None])
    recon = recon[0].numpy().astype(np.uint8).copy()
    recon = cv2.putText(recon, "image1_recon_est", top_left, font, scale_,
                        color, thick, ltype)

    img1 = cv2.putText(image1.copy(), "image1", top_left, font, scale_,
                       color, thick, ltype)
    img2 = cv2.putText(image2.copy(), "image2", top_left, font, scale_,
                       color, thick, ltype)

    all_vis = np.concatenate((img2, recon, flow_vis), axis=1)
    ref_vis = np.concatenate((img1, img1, flow_vis), axis=1)
    frames = [Image.fromarray(all_vis), Image.fromarray(ref_vis)]

    out_path = os.path.join(out_folder, filename + ".webp")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=500, loop=0)
    return out_path
