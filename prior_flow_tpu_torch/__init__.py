"""PriOr-Flow in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``prior_flow_tpu`` (JAX on a TPU) that imports nothing of it:
the test-mode PriOr-RAFT forward, with the DCCL level lookup and the
instance-norm statistics as CUDA kernels (``csrc/``), built at first use.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .models import PriOrRAFT, build_model

__all__ = ["PriOrRAFT", "build_model"]
