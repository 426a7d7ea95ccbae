"""PriOr-RAFT model and its factory."""

from __future__ import annotations

import torch

from ..checkpoint.convert import init_weights
from .prior_raft import PriOrRAFT, upsample_flow_convex


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is missing instead of
    running on the CPU unasked. Pass ``device="cpu"`` for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def build_model(device=None, seed: int = 0, state_dict=None,
                **kwargs) -> PriOrRAFT:
    """A PriOrRAFT in eval mode on ``device`` (default: the card).

    Weights come from ``state_dict`` (reference layout, loaded strictly)
    or, without one, from ``checkpoint.init_weights(seed)``. ``kwargs`` go
    to ``PriOrRAFT`` (e.g. ``mixed_precision=True``).
    """
    dev = resolve_device(device)
    model = PriOrRAFT(**kwargs)
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


__all__ = ["PriOrRAFT", "build_model", "resolve_device",
           "upsample_flow_convex"]
