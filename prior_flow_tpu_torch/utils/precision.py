"""The model's ``precision`` as a scope of torch's TF32 flags
(``prior_flow_tpu/models/prior_raft.py:142-144``). The flags are process
state, not part of a traced graph, so the model's forward, the training
step and the serving artifacts (``serving/export.py``) each run under
``precision_scope``. Imports no model code."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# the values of PriOrRAFT's ``precision``
PRECISIONS = (None, "highest")


def check_precision(precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


@contextlib.contextmanager
def precision_scope(precision: Optional[str]):
    """Runs its block at ``precision`` (one of ``PRECISIONS``): None leaves
    torch's backend flags alone; "highest" sets TF32 off for matmuls and
    cuDNN convolutions and restores the caller's settings on the way out.
    The flags are read and set through torch's ``fp32_precision`` API,
    whose saved values restore either API's settings exactly."""
    check_precision(precision)
    if precision is None:
        yield
        return
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    saved = [f.fp32_precision for f in flags]
    try:
        for f in flags:
            f.fp32_precision = "ieee"
        yield
    finally:
        for f, v in zip(flags, saved):
            f.fp32_precision = v
