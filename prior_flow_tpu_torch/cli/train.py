"""Training CLI (counterpart of ``prior_flow_tpu/cli/train.py``): the JAX
CLI's flags and presets, plus ``--device``. Runs on the card unless
``--device cpu`` is given.

    python -m prior_flow_tpu_torch.cli.train --stage EFT --preset \
        --mixed_precision --data_root /path/to/MPF [--validation EFT]

Presets (``scripts/train_*.sh``):

  EFT / City:  60k steps, batch 4, lr 1e-4, wdecay 1e-4
  FlowScape:   100k steps, batch 6, lr 1e-4, wdecay 1e-4

``--mesh`` as in the JAX CLI: ``auto`` trains data-parallel over every
card (one process per card, ``parallel.make_mesh``): under ``torchrun``
over its ranks, else by spawning one process per visible card, and on
one card (or ``--device cpu``) without a mesh. ``DPxSP`` asks for DP x
SP ranks, DP over the batch and, with SP above 1, SP over the image
height (``parallel.make_mesh_2d``, ``parallel/spatial.py``); it fails
unless DP x SP is the number visible (torchrun's world size, else the
cards, or 1 with ``--device cpu``). On N cards:

    torchrun --nproc_per_node=N -m prior_flow_tpu_torch.cli.train \
        --mesh auto --stage EFT --preset --mixed_precision --data_root ...

and on four, two data ranks of two height slices each:

    torchrun --nproc_per_node=4 -m prior_flow_tpu_torch.cli.train \
        --mesh 2x2 --stage EFT --preset --mixed_precision --data_root ...

``--batch_size`` is the global batch; each rank trains on its share.
``--remat_policy``
picks what each GRU iteration keeps for the backward, as in the JAX CLI:
``dccl`` (the default) only its lookup results, ``dots`` also every
convolution output; the rest is recomputed (``PriOrRAFT(remat_policy=)``).
The flags are the JAX CLI's, so no flag turns remat off:
``TrainerConfig(remat_policy="none")`` does, the fastest where the step
fits (the EFT recipe does).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

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
                        help="what each GRU iteration keeps for the "
                             "backward: 'dccl' only the lookup results "
                             "(least memory), 'dots' also every convolution "
                             "output (slower than 'dccl' in the port); the "
                             "rest runs again in the backward")

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
                        help="'auto' (data parallel over every visible card, "
                             "or torchrun's ranks) or 'DPxSP' (e.g. 2x2: DP "
                             "ranks over the batch, SP over the image "
                             "height)")
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


def mesh_ranks(spec: str, device=None):
    """``--mesh`` -> (ranks, under_torchrun): the ranks to train on (DP x
    SP), and whether ``torchrun`` started them
    (``prior_flow_tpu/cli/train.py:125-138``). Raises ``SystemExit`` with
    the JAX CLI's messages."""
    import torch

    world = os.environ.get("WORLD_SIZE")
    if world is not None:
        visible = int(world)
    elif str(device) == "cpu":
        visible = 1
    else:
        visible = torch.cuda.device_count()
    if spec == "auto":
        return max(visible, 1), world is not None
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise SystemExit(f"--mesh expects 'auto' or 'DPxSP' (e.g. 2x4); got "
                         f"{spec!r}")
    dp, sp = int(parts[0]), int(parts[1])
    # JAX's rule; 1x1 on a host without a card reaches resolve_device's
    # error instead
    if dp * sp != visible and not (dp * sp == 1 and visible == 0):
        raise SystemExit(f"--mesh {spec}: {dp}x{sp}={dp * sp} chips "
                         f"requested but {visible} visible")
    return dp * sp, world is not None


def mesh_shape(spec: str):
    """``--mesh`` -> the (DP, SP) shape of a data x space mesh where SP > 1,
    else None (a 1-D data mesh); ``mesh_ranks`` checks the spec first."""
    if spec == "auto":
        return None
    dp, sp = (int(p) for p in spec.lower().split("x"))
    return (dp, sp) if sp > 1 else None


def _rank_main(mesh, argv):
    """One spawned rank of ``main``."""
    train(parse_args(argv), mesh)


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.preset and args.stage in PRESETS:
        for k, v in PRESETS[args.stage].items():
            setattr(args, k, v)
    return args


def main(argv=None):
    """Train as the flags say; returns the ``Trainer`` (None where the
    ranks were spawned processes)."""
    args = parse_args(argv)
    ranks, torchrun = mesh_ranks(args.mesh, args.device)
    shape = mesh_shape(args.mesh)
    if ranks > 1 and not torchrun:
        from ..parallel.dryrun import spawn
        spawn(_rank_main, ranks, sys.argv[1:] if argv is None else argv,
              device=args.device or "cuda", timeout_s=None, shape=shape)
        return None
    mesh = None
    if ranks > 1:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(ranks, ("data",) if shape is None
                         else ("data", "space"), shape, device=args.device)
    return train(args, mesh)


def train(args, mesh=None):
    """``main``'s run on parsed flags, on ``mesh`` where given (this
    rank's part; only rank 0 logs)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s")
    os.makedirs(args.save_path, exist_ok=True)

    from ..data.datasets import fetch_dataloader
    from ..models import resolve_device
    from ..train.trainer import Trainer, TrainerConfig
    from ..utils.logger import MetricLogger

    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = TrainerConfig(
        name=args.name, stage=args.stage, lr=args.lr,
        num_steps=args.num_steps, batch_size=args.batch_size,
        iters=args.iters, wdecay=args.wdecay, epsilon=args.epsilon,
        clip=args.clip, gamma=args.gamma, add_noise=args.add_noise,
        mixed_precision=args.mixed_precision, dropout=args.dropout,
        save_path=args.save_path, restore_ckpt=args.restore_ckpt,
        validation=tuple(args.validation), seed=args.seed,
        data_root=args.data_root, val_freq=args.val_freq,
        grad_mode=args.grad_mode, remat_policy=args.remat_policy,
    )
    main_rank = mesh is None or mesh.rank == 0
    logger = MetricLogger.default(
        run_dir=os.path.join(args.save_path, "logs"), name=args.name,
        project=args.project_name, config=vars(args),
        use_wandb=args.wandb) if main_rank else None
    trainer = Trainer(cfg, device=device, logger=logger,
                      validators=make_validators(args), mesh=mesh)
    loader = fetch_dataloader(args)
    try:
        trainer.run(loader)
    finally:
        if logger is not None:
            logger.close()
    return trainer


if __name__ == "__main__":
    main()
