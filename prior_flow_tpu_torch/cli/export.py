"""Export CLI: the inference forward as a portable ``torch.export``
program (a ``.pt2`` file), optionally checked against the live model
(counterpart of ``prior_flow_tpu/cli/export.py``). Runs on the card unless
``--device cpu`` is given; the program runs at ``precision="highest"``
(TF32 off), as ``cli/evaluate.py``'s forward does by default.

    python -m prior_flow_tpu_torch.cli.export --model ckpt.pth \\
        --size 512 1024 --iters 12 --output prior_raft.pt2 --check
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True,
                        help="checkpoint (.pth, reference layout; an Orbax "
                             "dir needs convert_orbax.py first)")
    parser.add_argument("--output", default="prior_raft.pt2")
    parser.add_argument("--size", type=int, nargs=2, default=[512, 1024],
                        metavar=("H", "W"))
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--lookup_mode", default="auto",
                        choices=["auto", "pallas", "mxu", "gather"],
                        help="auto and pallas: the CUDA kernels; gather: the "
                             "plain lookup; mxu: not in the port yet")
    parser.add_argument("--platforms", nargs="*", default=None,
                        help="device types the program runs on (default: "
                             "the export device's; no other is possible)")
    parser.add_argument("--check", action="store_true",
                        help="reload the artifact and verify it matches the "
                             "live model on a random input")
    parser.add_argument("--device", default=None,
                        help="default: cuda (fails when absent)")
    args = parser.parse_args(argv)
    if args.lookup_mode == "mxu":
        parser.error("--lookup_mode mxu: the port has no MXU lookup yet "
                     "(ROADMAP Queue 1, item 11)")

    import torch

    from .. import serving
    from ..models import build_model, resolve_device
    from ..ops.corr import DCCLFused, dccl_level_lookup_plain
    from .demo_image import load_model_state

    device = resolve_device(args.device)
    model = build_model(device, state_dict=load_model_state(args.model),
                        mixed_precision=args.mixed_precision,
                        precision="highest")
    if args.lookup_mode == "gather":
        model.dccl = DCCLFused(model.corr_levels,
                               level_lookup=dccl_level_lookup_plain)
    state = model.state_dict()

    shape = (args.batch, args.size[0], args.size[1])
    exported = serving.export_forward(model, state, shape, iters=args.iters,
                                      platforms=args.platforms, device=device)
    serving.save_exported(exported, args.output)
    print(json.dumps({"output": args.output,
                      **serving.exported_summary(exported)}))

    if args.check:
        g = torch.Generator().manual_seed(0)
        img1, img2 = ((torch.rand((args.batch, *args.size, 3), generator=g)
                       * 255.0).to(device) for _ in range(2))
        got = serving.load_exported(args.output)(state, img1, img2)
        want = serving.make_forward(model, args.iters)(state, img1, img2)
        err = float((got - want).abs().max())
        print(json.dumps({"check_max_abs_err": err}))
        if not err < 1e-3:
            raise RuntimeError(f"exported artifact diverges: {err}")


if __name__ == "__main__":
    main()
