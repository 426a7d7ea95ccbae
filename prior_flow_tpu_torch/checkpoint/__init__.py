"""Checkpoint conversion, the FlyingThings graft, the reference ``.pth``
writer and seeded initialisation."""

from .convert import (convert_things_ckpt, init_weights, load_pth,
                      state_dict_from_jax, strip_module_prefix, write_pth)

__all__ = ["convert_things_ckpt", "init_weights", "load_pth",
           "state_dict_from_jax", "strip_module_prefix", "write_pth"]
