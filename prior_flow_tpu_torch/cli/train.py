"""Training CLI (counterpart of ``prior_flow_tpu/cli/train.py``): the JAX
CLI's flags and presets, plus ``--device``. Runs on the card unless
``--device cpu`` is given.

    python -m prior_flow_tpu_torch.cli.train --stage EFT --preset \
        --mixed_precision --data_root /path/to/MPF [--validation EFT]

Presets (``scripts/train_*.sh``):

  EFT / City:  60k steps, batch 4, lr 1e-4, wdecay 1e-4
  FlowScape:   100k steps, batch 6, lr 1e-4, wdecay 1e-4

One card only: ``--mesh`` takes ``auto`` or ``1x1``. ``--remat_policy`` is
accepted and not applied: the port keeps every activation (25.09 GB at
512x1024, batch 4, 12 iterations, bf16 on an H100).
"""

from __future__ import annotations

import argparse
import logging
import os

PRESETS = {
    "EFT": dict(num_steps=60000, batch_size=4, lr=1e-4, wdecay=1e-4),
    "City": dict(num_steps=60000, batch_size=4, lr=1e-4, wdecay=1e-4),
    "FlowScape": dict(num_steps=100000, batch_size=6, lr=1e-4, wdecay=1e-4),
}


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_name", default="PriOr-Flow")
    parser.add_argument("--name", default="EFT")
    parser.add_argument("--stage", required=True,
                        help="training dataset: City | EFT | FlowScape")
    parser.add_argument("--restore_ckpt", default=None,
                        help="a checkpoint directory of this CLI (model, "
                             "optimizer, step), a reference-layout .pth "
                             "(strict, else the FlyingThings graft), or "
                             "'auto' (the newest under --save_path)")
    parser.add_argument("--validation", type=str, nargs="+", default=[])
    parser.add_argument("--eval_batch_size", type=int, default=1,
                        help="pairs per forward of the periodic validation "
                             "(the same metrics)")
    parser.add_argument("--preset", action="store_true",
                        help="apply the canonical scripts/train_*.sh recipe")

    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--num_steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=6)
    parser.add_argument("--image_size", type=int, nargs="+", default=[384, 512])

    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--remat_policy", default="dccl",
                        choices=["dccl", "dots"],
                        help="accepted for the JAX CLI's surface and not "
                             "applied: the port keeps every activation "
                             "(25.09 GB at 512x1024, batch 4, 12 "
                             "iterations, bf16)")

    parser.add_argument("--grad_mode", default="standard",
                        choices=["standard", "taped"],
                        help="'taped' = single-forward deferred-scatter "
                             "backward (the same gradients, one stacked "
                             "volume scatter per level and branch instead "
                             "of one per GRU iteration)")
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--val_freq", type=int, default=5000,
                        help="checkpoint + validate every N steps")
    parser.add_argument("--wdecay", type=float, default=5e-5)
    parser.add_argument("--epsilon", type=float, default=1e-8)
    parser.add_argument("--clip", type=float, default=1.0)
    parser.add_argument("--gamma", type=float, default=0.8)
    parser.add_argument("--add_noise", action="store_true")

    parser.add_argument("--mesh", type=str, default="auto",
                        help="'auto' or '1x1': the port trains on one card "
                             "(data and space parallel meshes are ROADMAP "
                             "Queue 1, item 9)")
    parser.add_argument("--save_path", type=str, default="./checkpoints")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default=None,
                        help="default: cuda (fails when absent)")
    return parser


def make_validators(args):
    """The validators the loop may run, by ``--validation`` name: the
    model in, its metrics out."""
    from ..eval import evaluate as V

    def val(fn, **kw):
        return lambda model: fn(model, data_root=args.data_root,
                                batch_size=args.eval_batch_size, **kw)

    return {
        "City": val(V.validate_mpf, scene="City"),
        "EFT": val(V.validate_mpf, scene="EFT"),
        "FlowScape": val(V.validate_flowscape),
    }


def main(argv=None):
    """Train as the flags say; returns the ``Trainer``."""
    args = build_parser().parse_args(argv)
    if args.preset and args.stage in PRESETS:
        for k, v in PRESETS[args.stage].items():
            setattr(args, k, v)
    if args.mesh.lower() not in ("auto", "1x1"):
        raise SystemExit(
            f"--mesh {args.mesh}: the port trains on one card; data and "
            f"space parallel meshes are ROADMAP Queue 1, item 9 (parallel)")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    os.makedirs(args.save_path, exist_ok=True)

    from ..data.datasets import fetch_dataloader
    from ..models import resolve_device
    from ..train.trainer import Trainer, TrainerConfig
    from ..utils.logger import MetricLogger

    device = resolve_device(args.device)
    cfg = TrainerConfig(
        name=args.name, stage=args.stage, lr=args.lr,
        num_steps=args.num_steps, batch_size=args.batch_size,
        iters=args.iters, wdecay=args.wdecay, epsilon=args.epsilon,
        clip=args.clip, gamma=args.gamma, add_noise=args.add_noise,
        mixed_precision=args.mixed_precision, dropout=args.dropout,
        save_path=args.save_path, restore_ckpt=args.restore_ckpt,
        validation=tuple(args.validation), seed=args.seed,
        data_root=args.data_root, val_freq=args.val_freq,
        grad_mode=args.grad_mode,
    )
    logger = MetricLogger.default(
        run_dir=os.path.join(args.save_path, "logs"), name=args.name,
        project=args.project_name, config=vars(args), use_wandb=args.wandb)
    trainer = Trainer(cfg, device=device, logger=logger,
                      validators=make_validators(args))
    loader = fetch_dataloader(args)
    try:
        trainer.run(loader)
    finally:
        logger.close()
    return trainer


if __name__ == "__main__":
    main()
