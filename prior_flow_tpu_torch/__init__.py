"""PriOr-Flow in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``prior_flow_tpu`` (JAX on a TPU) that imports nothing of it:
the PriOr-RAFT forward, training (the step, the loop, the data pipeline
and ``cli/train.py``), the evaluation path (``eval``, ``data``, the CLIs),
and the measurement tools, with the DCCL lookup, its
scatter, the cross tap coords and the instance-norm statistics as CUDA
kernels (``csrc/``), built at first use.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .models import PriOrRAFT, build_model

__all__ = ["PriOrRAFT", "build_model"]
