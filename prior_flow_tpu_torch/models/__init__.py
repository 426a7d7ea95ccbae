"""PriOr-RAFT, the legacy RAFT family and their factories."""

from __future__ import annotations

import torch

from ..checkpoint.convert import init_weights
from .prior_raft import PriOrRAFT, precision_scope, upsample_flow_convex
from .raft import RAFT, corr_block_lookup


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is missing instead of
    running on the CPU unasked. Pass ``device="cpu"`` for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def _build(cls, device, seed: int, state_dict, kwargs):
    dev = resolve_device(device)
    model = cls(**kwargs)
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def build_model(device=None, seed: int = 0, state_dict=None,
                **kwargs) -> PriOrRAFT:
    """A PriOrRAFT in eval mode on ``device`` (default: the card).

    Weights come from ``state_dict`` (reference layout, loaded strictly)
    or, without one, from ``checkpoint.init_weights(seed)``. ``kwargs`` go
    to ``PriOrRAFT`` (e.g. ``mixed_precision=True``, ``precision="highest"``
    for full f32 convolutions and matmuls, ``corr_mode="onthefly"`` for
    inputs whose volumes outgrow the card, ``remat_policy="dots"`` or
    ``remat=False`` for training, ``lookup_mode="mxu"`` for the lookup
    without kernels, ``deferred_vol_grad=True``,
    ``bn_running_average=False``).
    """
    return _build(PriOrRAFT, device, seed, state_dict, kwargs)


def build_raft(device=None, seed: int = 0, state_dict=None,
               **kwargs) -> RAFT:
    """A legacy RAFT (``small=True`` for the small one) in eval mode on
    ``device`` (default: the card), its weights as ``build_model``'s;
    ``kwargs`` go to ``RAFT``."""
    return _build(RAFT, device, seed, state_dict, kwargs)


__all__ = ["PriOrRAFT", "RAFT", "build_model", "build_raft",
           "corr_block_lookup", "precision_scope", "resolve_device",
           "upsample_flow_convex"]
