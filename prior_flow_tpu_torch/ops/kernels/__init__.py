"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | replaces (JAX package) | wrapper |
| --- | --- | --- |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_grid_kernel`` | ``dccl_lookup.dccl_level_lookup`` |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_kernel`` | ``dccl_lookup.dccl_level_lookup_coords`` |
| ``csrc/dccl_lookup.cu`` | ``ops/pallas/dccl_gather.py::_dccl_grid_kernel_all`` | ``dccl_lookup.dccl_lookup_all_levels`` |
| ``csrc/instance_norm.cu`` | ``ops/pallas/instance_norm.py::_sums_kernel`` | ``instance_norm.instance_norm_sums`` |
| ``csrc/dccl_coords.cu`` (both branches, all levels) | ``ops/pallas/dccl_gather.py::_coords_kernel`` | ``dccl_coords.dccl_cross_coords`` |
| ``csrc/dccl_coords.cu`` (one branch, one level) | the same | ``dccl_coords.dccl_grid_coords`` |
| ``csrc/dccl_scatter.cu`` (grid entry) | the one-hot einsum backward of ``dccl_gather.py`` (``_scatter_own_cross``, ``_scatter_grads_*_multi``) | ``dccl_scatter.dccl_level_scatter_grid`` |
| ``csrc/dccl_scatter.cu`` (given coords) | the same, for the planes route | ``dccl_scatter.dccl_level_scatter`` |
| ``csrc/microbench_anchor.cu`` | ``tools/microbench_vpu_anchor.py::_kernel`` | ``anchors.anchor_chain`` |
| ``csrc/microbench_anchor.cu`` (the gather's read schedule) | the same | ``anchors.gather_plan`` |
| ``csrc/microbench_anchor.cu`` | ``tools/microbench_vpu_anchor.py::_copy_kernel`` | ``anchors.step_cost_copy`` |
| ``csrc/dccl_stages.cu`` | ``tools/microbench_kernel_split.py::_own_only_kernel`` | ``dccl_stages.dccl_own_only`` |
| ``csrc/dccl_stages.cu`` | ``tools/microbench_kernel_split.py::_gridwin_only_kernel`` | ``dccl_stages.dccl_gridwin_only`` |
| ``csrc/dccl_stages.cu`` | ``tools/microbench_kernel_split.py::_cross_only_kernel`` | ``dccl_stages.dccl_cross_only`` |
| ``csrc/dccl_coords.cu`` (both branches, one level) | ``tools/microbench_gridwin.py::_pair_kernel`` | ``gridwin_variants.gridwin_pair`` |
| ``csrc/gridwin_variants.cu``, ``csrc/dccl_coords.cu`` (direct) | ``tools/microbench_gridwin.py::_variant_kernel`` | ``gridwin_variants.gridwin_variant`` |

``csrc/dccl_common.cuh`` holds the sampler and window arithmetic the DCCL
kernels share, ``csrc/dccl_columns.cuh`` the column body of the lookup
and its stages, the coords kernel and the grid-window variants. The last
eight rows are the kernels of the port's
measurement tools (``prior_flow_tpu_torch/tools``), off the model's paths.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from .anchors import anchor_chain, gather_plan, step_cost_copy
from .dccl_coords import dccl_cross_coords, dccl_grid_coords
from .dccl_lookup import (dccl_level_lookup, dccl_level_lookup_coords,
                          dccl_lookup_all_levels)
from .dccl_scatter import dccl_level_scatter, dccl_level_scatter_grid
from .dccl_stages import dccl_cross_only, dccl_gridwin_only, dccl_own_only
from .gridwin_variants import gridwin_pair, gridwin_variant
from .instance_norm import instance_norm_sums

WRAPPERS = {"dccl_level_lookup": dccl_level_lookup,
            "instance_norm_sums": instance_norm_sums,
            "dccl_cross_coords": dccl_cross_coords,
            "dccl_grid_coords": dccl_grid_coords,
            "dccl_level_scatter": dccl_level_scatter,
            "dccl_level_scatter_grid": dccl_level_scatter_grid,
            "dccl_level_lookup_coords": dccl_level_lookup_coords,
            "dccl_lookup_all_levels": dccl_lookup_all_levels,
            "anchor_chain": anchor_chain,
            "gather_plan": gather_plan,
            "step_cost_copy": step_cost_copy,
            "dccl_own_only": dccl_own_only,
            "dccl_gridwin_only": dccl_gridwin_only,
            "dccl_cross_only": dccl_cross_only,
            "gridwin_pair": gridwin_pair,
            "gridwin_variant": gridwin_variant}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
