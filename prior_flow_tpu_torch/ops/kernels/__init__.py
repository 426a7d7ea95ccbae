"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | replaces (JAX package) | wrapper |
| --- | --- | --- |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_grid_kernel`` | ``dccl_lookup.dccl_level_lookup`` |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_kernel`` | ``dccl_lookup.dccl_level_lookup_coords`` |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_grid_kernel_all`` | ``dccl_lookup.dccl_lookup_all_levels`` |
| ``csrc/instance_norm.cu`` | ``ops/pallas/instance_norm.py::_sums_kernel`` | ``instance_norm.instance_norm_sums`` |
| ``csrc/dccl_coords.cu`` | ``ops/pallas/dccl_gather.py::_coords_kernel`` | ``dccl_coords.dccl_grid_coords`` |
| ``csrc/dccl_scatter.cu`` | the one-hot einsum backward of ``dccl_gather.py`` (``_scatter_own_cross``, ``_scatter_grads_*_multi``) | ``dccl_scatter.dccl_level_scatter`` |

``csrc/dccl_common.cuh`` holds the sampler and window arithmetic the DCCL
kernels share. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from .dccl_coords import dccl_grid_coords
from .dccl_lookup import (dccl_level_lookup, dccl_level_lookup_coords,
                          dccl_lookup_all_levels)
from .dccl_scatter import dccl_level_scatter
from .instance_norm import instance_norm_sums

WRAPPERS = {"dccl_level_lookup": dccl_level_lookup,
            "instance_norm_sums": instance_norm_sums,
            "dccl_grid_coords": dccl_grid_coords,
            "dccl_level_scatter": dccl_level_scatter,
            "dccl_level_lookup_coords": dccl_level_lookup_coords,
            "dccl_lookup_all_levels": dccl_lookup_all_levels}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
