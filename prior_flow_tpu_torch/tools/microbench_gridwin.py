"""Variants of the DCCL grid-window stage, timed on the card.

Counterpart of the JAX package's ``tools/microbench_gridwin.py``, on the
port's kernels (``ops/kernels/gridwin_variants.py``). The grid-window stage
(both rotation grids sampled at the 81 window taps of each centre) costs
the same at every pyramid level; this tool times where its grid reads come
from, each variant on kernel 1's grid-window column body: ``direct`` (the
read-only cache: the coords kernel's both-branch entry at one centre set)
and ``smem_grid`` (both grids staged in shared memory), the two
diagnostics that split the column body's time, ``reads`` (its row-pair
reads alone) and ``arith`` (its corner arithmetic alone), and
``gridwin_pair`` (both branches at their own centres, the same entry),
beside two one-branch launches of the coords kernel (``dccl_grid_coords``).

At Q = 8192 centres (the 1/8 identity grid of a 512x1024 input plus N(0, 5)
noise; the pair's B centres are the A centres reversed), scale 1.0, the
input's 64x128 grids. Every semantic variant and the pair are first gated
bitwise against the coords kernel, the diagnostics bitwise against their
plain versions; then one JSON line of the card's ms per launch (launches
queued ahead, ``_timing.queued_ms``).

    python -m prior_flow_tpu_torch.tools.microbench_gridwin
"""

from __future__ import annotations

import json

import torch

from ..geometry import identity_grid_on, rotation_grids
from ..models import resolve_device
from ..ops.kernels import launch_counts, reset_launch_counts
from ..ops.kernels.dccl_coords import dccl_grid_coords
from ..ops.kernels.gridwin_variants import (DIAGNOSTIC_PLAINS, DIAGNOSTICS,
                                            VARIANTS, gridwin_pair,
                                            gridwin_pair_plain,
                                            gridwin_variant)
from ._timing import nvidia_smi, queued_ms

H, W = 512, 1024
SCALE = 1.0


class GateError(RuntimeError):
    """A variant disagreed with the coords kernel."""


def inputs(device, seed: int = 0, size=(H, W)):
    """(cen_A, cen_B, grid_A, grid_B): (Q, 2) centres, cen_B = cen_A
    reversed, and the ``size`` (512x1024) input's two 1/8 rotation
    grids."""
    g = torch.Generator(device=device).manual_seed(seed)
    h8, w8 = size[0] // 8, size[1] // 8
    cen = identity_grid_on(h8, w8, device).reshape(-1, 2) + 5 * torch.randn(
        h8 * w8, 2, generator=g, device=device)
    grids = rotation_grids(*size).to_device(device)
    return (cen.contiguous(), cen.flip(0).contiguous(), grids.a2b_w2c_8,
            grids.b2a_w2c_8)


def coords_kernel_pair(cen_A, cen_B, grid_A, grid_B, scale: float = SCALE):
    """Both branches' coords by two coords-kernel launches."""
    return (*dccl_grid_coords(cen_A, grid_A, scale),
            *dccl_grid_coords(cen_B, grid_B, scale))


def gate(cen_A, cen_B, grid_A, grid_B, scale: float = SCALE) -> None:
    """Raises GateError unless every semantic variant (at cen_A) and the
    pair are bitwise two coords-kernel launches, these their plain
    version, and each diagnostic its plain version."""
    with torch.no_grad():
        one = coords_kernel_pair(cen_A, cen_A, grid_A, grid_B, scale)
        two = coords_kernel_pair(cen_A, cen_B, grid_A, grid_B, scale)
        checks = [(f"variant {v} vs the coords kernel", gridwin_variant(cen_A, grid_A, grid_B,
                                                   scale, v), one)
                  for v in VARIANTS]
        checks += [("pair vs the coords kernel", gridwin_pair(cen_A, cen_B, grid_A, grid_B, scale),
                    two),
                   ("coords kernel vs plain", two,
                    gridwin_pair_plain(cen_A, cen_B, grid_A, grid_B, scale))]
        checks += [(f"diagnostic {v} vs plain",
                    gridwin_variant(cen_A, grid_A, grid_B, scale, v),
                    DIAGNOSTIC_PLAINS[v](cen_A, grid_A, grid_B, scale))
                   for v in DIAGNOSTICS]
        for name, got, want in checks:
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                err = max((a - b).abs().max().item()
                          for a, b in zip(got, want))
                raise GateError(f"gridwin {name}: not bitwise equal (max abs "
                                f"err {err})")


def measure(cen_A, cen_B, grid_A, grid_B, scale: float = SCALE,
            n: int = 50) -> dict:
    """The card's ms (``queued_ms``) of two coords-kernel launches, of each
    variant and diagnostic at cen_A, and of the pair."""
    with torch.no_grad():
        rec = {"coords_kernel_x2_ms": queued_ms(lambda: coords_kernel_pair(
            cen_A, cen_A, grid_A, grid_B, scale), n)}
        for v in list(VARIANTS) + list(DIAGNOSTICS):
            rec[f"{v}_ms"] = queued_ms(lambda: gridwin_variant(
                cen_A, grid_A, grid_B, scale, v), n)
        rec["pair_ms"] = queued_ms(lambda: gridwin_pair(
            cen_A, cen_B, grid_A, grid_B, scale), n)
    return rec


def run(device):
    """The tool's procedure: gated (GateError), then measured. Returns
    (ins, rec, launches): ``inputs``, ``measure``'s record and the
    measurement's launch counts."""
    ins = inputs(device)
    gate(*ins)
    reset_launch_counts()
    rec = measure(*ins)
    return ins, rec, launch_counts()


def main() -> None:
    dev = resolve_device()
    print(nvidia_smi("name,power.limit"), flush=True)
    ins, rec, _ = run(dev)
    print(json.dumps({"Q": ins[0].shape[0], "grid": list(ins[2].shape[:2]),
                      **rec}), flush=True)


if __name__ == "__main__":
    main()
