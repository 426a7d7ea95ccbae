#!/usr/bin/env python3
"""Convert an Orbax checkpoint of the JAX package into a reference-layout
``.pth`` that the PyTorch port reads (``prior_flow_tpu_torch.checkpoint.
load_pth``: the CLIs' ``--model``, ``Trainer.restore``).

    python convert_orbax.py CKPT_DIR OUT.pth

CKPT_DIR holds bare model variables (``checkpoint.orbax_io.
save_variables``) or a Trainer ``TrainState`` (``save_train_state``);
``variables_from_checkpoint`` reads either. The variables go through
``checkpoint.convert.export_state_dict`` (OIHW kernels, ``module.``
-prefixed names, BatchNorm statistics as running_mean / running_var) and
are written with ``torch.save``.

Needs JAX, Orbax and torch: run it where the JAX package runs. It lies
outside ``prior_flow_tpu_torch``, which imports no JAX.
"""

from __future__ import annotations

import argparse


def convert(ckpt_dir: str, out_path: str) -> int:
    """Write ``ckpt_dir``'s variables to ``out_path``; returns the number of
    tensors written."""
    import numpy as np
    import torch

    from prior_flow_tpu.checkpoint.convert import export_state_dict
    from prior_flow_tpu.checkpoint.orbax_io import variables_from_checkpoint

    sd = export_state_dict(variables_from_checkpoint(ckpt_dir))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, out_path)
    return len(sd)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir", help="Orbax checkpoint directory")
    ap.add_argument("out", help="the .pth to write")
    args = ap.parse_args(argv)
    n = convert(args.ckpt_dir, args.out)
    print(f"wrote {args.out} ({n} tensors)")


if __name__ == "__main__":
    main()
