"""Flow over an ordered directory of frames, with an optional warm start
(counterpart of ``prior_flow_tpu/cli/video.py``): each pair's flow is
written as ``<frame stem>.flo``; with ``--warm_start`` the previous pair's
flow at 1/8 is forward-splatted (``forward_interpolate``) and given as
the next pair's ``init_flow``. Runs on the card unless ``--device cpu``
is given.

    python -m prior_flow_tpu_torch.cli.video --model ckpt.pth \
        --input frames/ --output flows/ --warm_start --viz
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="checkpoint (.pth, reference layout)")
    parser.add_argument("--input", required=True,
                        help="directory of ordered frames (png/jpg)")
    parser.add_argument("--output", default="flows_out")
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--warm_start", action="store_true",
                        help="chain each pair's init from the previous flow")
    parser.add_argument("--viz", action="store_true",
                        help="also write colorized flow PNGs")
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="default: cuda (fails when absent)")
    args = parser.parse_args(argv)

    import torch

    from ..data import frame_utils
    from ..models import build_model, resolve_device
    from ..ops.warp import downflow8
    from ..utils.padder import InputPadder, forward_interpolate
    from .demo_image import load_image, load_model_state

    frames = sorted(
        f for f in glob(osp.join(args.input, "*"))
        if osp.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg"))
    if len(frames) < 2:
        raise SystemExit(f"{args.input}: need >= 2 frames, found {len(frames)}")
    if args.max_pairs is not None:
        if args.max_pairs < 1:
            raise SystemExit(f"--max_pairs must be >= 1, got {args.max_pairs}")
        frames = frames[:args.max_pairs + 1]

    device = resolve_device(args.device)
    model = build_model(device, state_dict=load_model_state(args.model),
                        mixed_precision=args.mixed_precision)

    def load(path):
        return torch.from_numpy(load_image(path)).to(device)

    os.makedirs(args.output, exist_ok=True)
    init = None
    padder = None
    for i in range(len(frames) - 1):
        im1, im2 = load(frames[i]), load(frames[i + 1])
        if padder is None:
            padder = InputPadder(im1.shape)
        im1, im2 = padder.pad(im1, im2)
        if init is None:
            # a zero start on the first pair, as the JAX CLI's
            init = torch.zeros((1, im1.shape[1] // 8, im1.shape[2] // 8, 2),
                               device=device)
        flow_up = model(im1, im2, iters=args.iters, init_flow=init)
        flow = padder.unpad(flow_up)[0].cpu().numpy()
        stem = osp.splitext(osp.basename(frames[i]))[0]
        frame_utils.write_flo(osp.join(args.output, f"{stem}.flo"), flow)
        if args.viz:
            from ..utils.flow_viz import omniflow_to_image
            frame_utils.write_image(osp.join(args.output, f"{stem}.png"),
                                    omniflow_to_image(flow))
        if args.warm_start:
            low = downflow8(flow_up)[0]
            init = torch.from_numpy(forward_interpolate(low))[None].to(device)
        print(f"{stem}: flow range u[{flow[..., 0].min():.2f}, "
              f"{flow[..., 0].max():.2f}] v[{flow[..., 1].min():.2f}, "
              f"{flow[..., 1].max():.2f}]")
    print(f"wrote {len(frames) - 1} flows to {args.output}")


if __name__ == "__main__":
    main()
