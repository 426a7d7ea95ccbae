"""Evaluation CLI (counterpart of ``prior_flow_tpu/cli/evaluate.py``):
EPE and SEPE of a checkpoint on a panoramic test split, over the whole
image or per region. Runs on the card unless ``--device cpu`` is given.

    python -m prior_flow_tpu_torch.cli.evaluate --model ckpt.pth \
        --dataset MPFDataset --scene EFT --data_root /path/to/MPF [--regions]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="checkpoint (.pth, reference layout)")
    parser.add_argument("--dataset",
                        choices=["MPFDataset", "FlowScape", "City100"],
                        required=True)
    parser.add_argument("--scene", default="EFT",
                        choices=["City", "EFT", "cloud", "fog", "rain",
                                 "sunny", "all"])
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--regions", action="store_true")
    parser.add_argument("--iters", type=int, default=None,
                        help="GRU iterations (default 12; 24 for City100)")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--eval_batch_size", type=int, default=1)
    # full f32 convolutions and matmuls by default, as the JAX CLI's
    # "highest"; "fastest" leaves torch's flags (TF32 convolutions)
    parser.add_argument("--precision", default="highest",
                        choices=["highest", "fastest"])
    parser.add_argument("--device", default=None,
                        help="default: cuda (fails when absent)")
    args = parser.parse_args(argv)

    from ..eval import evaluate as V
    from ..models import build_model, resolve_device
    from .demo_image import load_model_state

    device = resolve_device(args.device)
    model = build_model(device, state_dict=load_model_state(args.model),
                        dropout=args.dropout,
                        mixed_precision=args.mixed_precision,
                        precision=None if args.precision == "fastest"
                        else args.precision)

    default_iters = 24 if args.dataset == "City100" else 12
    kw = dict(iters=args.iters if args.iters is not None else default_iters,
              data_root=args.data_root, max_samples=args.max_samples,
              batch_size=args.eval_batch_size)
    if args.dataset == "City100":
        return V.validate_city_regions(model, **kw)
    if args.dataset == "MPFDataset":
        if args.scene not in ("City", "EFT", "all"):
            parser.error(f"--scene {args.scene} is not an MPFDataset scene")
        if args.regions:
            return V.validate_mpf_regions(model, scene=args.scene, **kw)
        return V.validate_mpf(model, scene=args.scene, **kw)
    if args.scene not in ("cloud", "fog", "rain", "sunny", "all"):
        parser.error(f"--scene {args.scene} is not a FlowScape scene")
    if args.regions:
        return V.validate_flowscape_regions(model, scene=args.scene, **kw)
    return V.validate_flowscape(model, scene=args.scene, **kw)


if __name__ == "__main__":
    main()
