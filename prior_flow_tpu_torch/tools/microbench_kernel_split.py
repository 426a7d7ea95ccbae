"""Split the DCCL level lookup's cost into its three stages on the card.

Counterpart of the JAX package's ``tools/microbench_kernel_split.py``, on
the port's kernels. Kernel 1 (``dccl_level_lookup``) costs about as much at
the upper pyramid levels of a 512x1024 input as at level 0, while the
volumes shrink 4x per level; the stages that could set that floor, per
level launch:

- own: both branches' own 9x9 windows sampled in their own volumes;
- grid window: both rotation grids sampled at the windows (cross tap
  coords), a cost independent of the level's volume;
- cross: the grid window plus the cross taps sampled in the other volume.

Per level this tool runs kernel 1 (``grid_full``), the lookup at given
coords at random in-range coords (``planes``) and each stage alone
(``dccl_stages``: kernel 1's column body with the other stages compiled
out), at 512x1024, batch 1 (Q = 8192), f32 and bf16 volumes:
two different random normal volumes, centres on the 1/8 identity grid plus
a random fraction. It first gates the stages: own and cross bitwise equal
to kernel 1's own and cross outputs, the grid window bitwise equal to two
coords-kernel launches, each within ``PLAIN_ATOL`` of its plain version.
Then it prints one JSON line per (dtype, level): the card's ms per launch
of each (launches queued ahead, ``_timing.queued_ms``), and kernel 1's ms
issued back to back as the forward issues it (``grid_full_paced_ms``).

    python -m prior_flow_tpu_torch.tools.microbench_kernel_split
"""

from __future__ import annotations

import json

import torch

from ..geometry import identity_grid_on, rotation_grids
from ..models import resolve_device
from ..ops.kernels import launch_counts, reset_launch_counts
from ..ops.kernels.dccl_coords import dccl_grid_coords
from ..ops.kernels.dccl_lookup import (NTAP, dccl_level_lookup,
                                       dccl_level_lookup_coords)
from ..ops.kernels.dccl_stages import (PLAIN, dccl_cross_only,
                                       dccl_gridwin_only, dccl_own_only)
from ._timing import cuda_ms, nvidia_smi, queued_ms

H, W = 512, 1024
LEVELS = 4
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
STAGES = {"own_only": dccl_own_only, "gridwin_only": dccl_gridwin_only,
          "cross_only": dccl_cross_only}
PLAIN_ATOL = 2e-5   # unit-scale volumes; kernel and plain round alike


class GateError(RuntimeError):
    """A stage disagreed with kernel 1, the coords kernel or its plain
    version."""


def level_inputs(device, dtype, lvl: int, seed: int = 0, size=(H, W)):
    """Kernel 1's arguments at one level of a ``size`` (512x1024) input,
    batch 1: volumes A and B (1, Q, Hl, Wl), two different random normals;
    centres (1, Q, 2), the identity grid plus a random fraction in [0, 1)
    (another for B); the input's two 1/8 rotation grids; the level
    scale."""
    g = torch.Generator(device=device).manual_seed(seed + lvl)
    h8, w8 = size[0] // 8, size[1] // 8
    Q = h8 * w8
    Hl, Wl = h8 >> lvl, w8 >> lvl
    vA = torch.randn(1, Q, Hl, Wl, generator=g, device=device).to(dtype)
    vB = torch.randn(1, Q, Hl, Wl, generator=g, device=device).to(dtype)
    base = identity_grid_on(h8, w8, device).reshape(1, Q, 2)
    cA = base + torch.rand(1, Q, 2, generator=g, device=device)
    cB = base + torch.rand(1, Q, 2, generator=g, device=device)
    grids = rotation_grids(*size).to_device(device)
    return (vA, vB, cA, cB, grids.a2b_w2c_8, grids.b2a_w2c_8), 1.0 / 2 ** lvl


def planes_coords(ins, seed: int = 0):
    """Random in-range cross coords (cxA, cyA, cxB, cyB), each (1, Q, 81),
    for the lookup at given coords."""
    vA = ins[0]
    _, Q, Hl, Wl = vA.shape
    g = torch.Generator(device=vA.device).manual_seed(seed + 10)
    u = torch.rand(4, 1, Q, NTAP, generator=g, device=vA.device)
    return (u[0] * Wl, u[1] * Hl, u[2] * Wl, u[3] * Hl)


def _differ(a, b) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def gate(ins, scale: float) -> dict:
    """Raises GateError unless own and cross are bitwise kernel 1's, the
    grid window bitwise two coords-kernel launches, and each stage within
    PLAIN_ATOL of its plain version. Returns each stage's max abs error
    against its plain version."""
    vA, vB, cA, cB, gA, gB = ins
    with torch.no_grad():
        got = {name: fn(*ins, scale) for name, fn in STAGES.items()}
        oA, xA, oB, xB = dccl_level_lookup(*ins, scale)
        coords = (*dccl_grid_coords(cA.reshape(-1, 2), gA, scale),
                  *dccl_grid_coords(cB.reshape(-1, 2), gB, scale))
        want = {"own_only": (oA, oB), "cross_only": (xA, xB),
                "gridwin_only": tuple(c.reshape(oA.shape) for c in coords)}
        errs = {}
        for name, outs in got.items():
            if not all(torch.equal(a, b) for a, b in zip(outs, want[name])):
                other = ("two coords-kernel launches" if name == "gridwin_only"
                         else "kernel 1")
                raise GateError(f"{name}: not bitwise equal to {other} (max "
                                f"abs err {_differ(outs, want[name])})")
            plain = PLAIN[name.split("_")[0]](*ins, scale)
            errs[name] = _differ(outs, plain)
            limit = 0.0 if name == "gridwin_only" else PLAIN_ATOL
            if not errs[name] <= limit:
                raise GateError(f"{name}: max abs err {errs[name]} from its "
                                f"plain version > {limit}")
    return errs


def measure(ins, scale: float, planes, n: int = 50) -> dict:
    """The card's ms per launch (``queued_ms``) of kernel 1, the lookup at
    given coords and each stage; and kernel 1's ms issued back to back
    (``cuda_ms``, ``grid_full_paced_ms``), as the forward issues it."""
    vA, vB, cA, cB, _, _ = ins
    with torch.no_grad():
        rec = {"grid_full_ms": queued_ms(
                   lambda: dccl_level_lookup(*ins, scale), n),
               "planes_ms": queued_ms(lambda: dccl_level_lookup_coords(
                   vA, vB, cA, cB, scale, *planes), n)}
        for name, fn in STAGES.items():
            rec[f"{name}_ms"] = queued_ms(lambda: fn(*ins, scale), n)
        rec["grid_full_paced_ms"] = cuda_ms(
            lambda: dccl_level_lookup(*ins, scale), n)
    return rec


def run(device):
    """The tool's procedure: per (dtype, level), the stages gated
    (GateError), then measured. Yields one dict per (dtype, level): dtype
    tag, level, ins and scale (``level_inputs``), planes
    (``planes_coords``), errs (``gate``), rec (``measure``) and launches
    (the measurement's launch counts)."""
    for tag, dtype in DTYPES.items():
        for lvl in range(LEVELS):
            ins, scale = level_inputs(device, dtype, lvl)
            try:
                errs = gate(ins, scale)
            except GateError as e:
                raise GateError(f"{tag} level {lvl}: {e}") from e
            planes = planes_coords(ins)
            reset_launch_counts()
            rec = measure(ins, scale, planes)
            yield dict(dtype=tag, level=lvl, ins=ins, scale=scale,
                       planes=planes, errs=errs, rec=rec,
                       launches=launch_counts())


def main() -> None:
    dev = resolve_device()
    print(nvidia_smi("name,power.limit"), flush=True)
    for r in run(dev):
        _, Q, Hl, Wl = r["ins"][0].shape
        print(json.dumps({"dtype": r["dtype"], "level": r["level"], "Q": Q,
                          "Hl": Hl, "Wl": Wl, **r["rec"]}), flush=True)


if __name__ == "__main__":
    main()
