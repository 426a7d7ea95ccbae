"""Smoke-test CLI: a random pair (512x1024 unless ``--height``/``--width``
say otherwise) through the test-mode forward; prints the output shape and
the steady-state time. Runs on the card unless ``--device cpu`` is given
(counterpart of ``prior_flow_tpu/cli/demo.py``).

    python -m prior_flow_tpu_torch.cli.demo [--mixed_precision] [--iters 12]
    python -m prior_flow_tpu_torch.cli.demo --height 1024 --width 2048
"""

from __future__ import annotations

import argparse
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--device", default=None,
                        help="default: cuda (fails when absent)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from ..models import build_model, resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model = build_model(device, seed=args.seed, dropout=args.dropout,
                        mixed_precision=args.mixed_precision)
    print(f"init: {time.perf_counter() - t0:.1f}s on {device}")
    gen = torch.Generator().manual_seed(args.seed + 1)
    shape = (1, args.height, args.width, 3)
    image1 = (torch.rand(shape, generator=gen) * 255).to(device)
    image2 = (torch.rand(shape, generator=gen) * 255).to(device)

    t0 = time.perf_counter()
    flow = model(image1, image2, iters=args.iters)
    _sync(device)
    print(f"first forward (incl. kernel build): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    flow = model(image1, image2, iters=args.iters)
    _sync(device)
    print(f"steady-state forward: {time.perf_counter() - t0:.3f}s")
    print("output:", tuple(flow.shape), flow.dtype)
    return flow


if __name__ == "__main__":
    main()
