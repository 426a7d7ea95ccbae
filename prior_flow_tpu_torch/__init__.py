"""PriOr-Flow in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``prior_flow_tpu`` (JAX on a TPU) that imports nothing of it:
the PriOr-RAFT forward, training (the step, the loop, the data pipeline
and ``cli/train.py``), the evaluation path (``eval``, ``data``, the CLIs),
the legacy RAFT family (``models.RAFT``) and the measurement tools, with the DCCL lookup, its
scatter, the cross tap coords and the instance-norm statistics as CUDA
kernels (``csrc/``), built at first use.
Entry points run on the card unless the caller passes ``device="cpu"``.

``PriOrRAFT`` and ``build_model`` are imported on first use, so that a
serving process can load an exported program (``serving.load_exported``)
without importing the model code.
"""

__all__ = ["PriOrRAFT", "build_model"]


def __getattr__(name):
    if name in __all__:
        from . import models
        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
