"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | replaces (JAX package) | wrapper |
| --- | --- | --- |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_grid_kernel`` | ``dccl_lookup.dccl_level_lookup`` |
| ``csrc/instance_norm.cu`` | ``ops/pallas/instance_norm.py::_sums_kernel`` | ``instance_norm.instance_norm_sums`` |

Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from .dccl_lookup import dccl_level_lookup
from .instance_norm import instance_norm_sums

WRAPPERS = {"dccl_level_lookup": dccl_level_lookup,
            "instance_norm_sums": instance_norm_sums}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
