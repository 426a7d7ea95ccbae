"""Checkpoint conversion and seeded initialisation."""

from .convert import (init_weights, load_pth, state_dict_from_jax,
                      strip_module_prefix)

__all__ = ["init_weights", "load_pth", "state_dict_from_jax",
           "strip_module_prefix"]
