"""Inference on one image pair: load a checkpoint, run the test-mode
forward, write the flow's colour map (counterpart of
``prior_flow_tpu/cli/demo_image.py``). Runs on the card unless
``--device cpu`` is given.

    python -m prior_flow_tpu_torch.cli.demo_image --model ckpt.pth \
        --image1 a.png --image2 b.png --output flow_pr.png [--gif]
"""

from __future__ import annotations

import argparse
import os


def load_image(path):
    """(1, H, W, 3) float32 RGB in [0, 255]; grey images are tiled."""
    import numpy as np

    from ..data import frame_utils

    img = np.asarray(frame_utils.read_image(path)).astype(np.float32)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    return img[None, :, :, :3]


def load_model_state(ckpt_path: str):
    """The state dict of a reference-layout ``.pth`` checkpoint. An Orbax
    directory (the JAX package's own format) needs JAX to read, so the port
    refuses it and names the converter, ``convert_orbax.py`` at the root of
    the repository."""
    from ..checkpoint.convert import ORBAX_HINT, load_pth

    if os.path.isdir(ckpt_path):
        raise ValueError(
            f"{ckpt_path} is a directory (an Orbax checkpoint?): the port "
            f"reads only .pth files in the reference layout; {ORBAX_HINT}")
    return load_pth(ckpt_path)


def resize_bilinear(image, size):
    """(B, H, W, C) -> (B, h, w, C), half-pixel bilinear with antialiasing
    when shrinking (``jax.image.resize(..., "bilinear")``'s filter)."""
    from torch.nn import functional as F

    x = image.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).contiguous()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="checkpoint (.pth, reference layout)")
    parser.add_argument("--image1", default="demo-frames/frame1.png")
    parser.add_argument("--image2", default="demo-frames/frame2.png")
    parser.add_argument("--output", default="flow_pr.png")
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--gif", action="store_true",
                        help="also write a side-by-side webp animation")
    parser.add_argument("--size", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="bilinearly resize inputs before inference "
                             "(flow is reported at the resized resolution)")
    parser.add_argument("--device", default=None,
                        help="default: cuda (fails when absent)")
    args = parser.parse_args(argv)

    import torch

    from ..data import frame_utils
    from ..models import build_model, resolve_device
    from ..utils import flow_viz
    from ..utils.padder import InputPadder

    device = resolve_device(args.device)
    image1 = torch.from_numpy(load_image(args.image1)).to(device)
    image2 = torch.from_numpy(load_image(args.image2)).to(device)
    if args.size is not None:
        image1 = resize_bilinear(image1, args.size)
        image2 = resize_bilinear(image2, args.size)

    model = build_model(device, state_dict=load_model_state(args.model),
                        dropout=args.dropout,
                        mixed_precision=args.mixed_precision)
    padder = InputPadder(image1.shape)
    i1, i2 = padder.pad(image1, image2)
    flow = padder.unpad(model(i1, i2, iters=args.iters))[0].cpu().numpy()

    frame_utils.write_image(args.output, flow_viz.omniflow_to_image(flow))
    print(f"wrote {args.output}  (flow range u[{flow[..., 0].min():.1f},"
          f"{flow[..., 0].max():.1f}] v[{flow[..., 1].min():.1f},"
          f"{flow[..., 1].max():.1f}])")
    if args.gif:
        out = flow_viz.save_gif(image1[0].cpu().numpy(),
                                image2[0].cpu().numpy(), flow,
                                os.path.splitext(args.output)[0],
                                os.path.dirname(args.output) or ".")
        print(f"wrote {out}")
    return flow


if __name__ == "__main__":
    main()
