"""Blocks per SM of the coords kernel, timed on the card.

The coords kernel (``csrc/dccl_coords.cu``) caps its registers through
``__launch_bounds__(288, kBlocksPerSM)``. This tool builds that source once
per candidate count, with only the constant changed, into a shared library
of its own under ``build/coords_occupancy/``; prints ``ptxas``'s registers
and spills for each; checks each library's both-branch entry bitwise
against the plain version; and times it with launches queued ahead
(``_timing.queued_ms``) at two calls: the 1024x2048 planes route's (both
branches, four levels, 32768 centres) and the grid-window tool's pair (one
level, 8192 centres, 64x128 grids).

    python -m prior_flow_tpu_torch.tools.coords_occupancy
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from ..models import resolve_device
from ..ops.kernels import _build
from ..ops.kernels.dccl_coords import (CROSS_COORDS_ARGTYPES,
                                       dccl_cross_coords_plain)
from . import microbench_gridwin as gw
from ._timing import nvidia_smi, queued_ms

BLOCKS = (4, 5, 6, 7)
OUT_DIR = _build.BUILD_DIR.parent / "coords_occupancy"
CALLS = {"planes_1024x2048": ((1024, 2048), (1.0, 0.5, 0.25, 0.125)),
         "pair_512x1024": ((512, 1024), (1.0,))}
_CONSTANT = re.compile(r"constexpr int kBlocksPerSM = \d+;")


def variant_source(blocks: int) -> str:
    """dccl_coords.cu with ``kBlocksPerSM`` set to ``blocks``."""
    src = (_build.CSRC_DIR / "dccl_coords.cu").read_text()
    if len(_CONSTANT.findall(src)) != 1:
        raise RuntimeError("dccl_coords.cu: no single kBlocksPerSM constant")
    return _CONSTANT.sub(f"constexpr int kBlocksPerSM = {blocks};", src)


def build(blocks: int):
    """(the variant's dccl_cross_coords entry, ptxas's register lines)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu = OUT_DIR / f"dccl_coords_{blocks}.cu"
    so = OUT_DIR / f"dccl_coords_{blocks}.so"
    cu.write_text(variant_source(blocks))
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC_DIR), "-shared", "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{res.stdout}"
                           f"{res.stderr}")
    log = [line.split(":", 1)[-1].strip()
           for line in (res.stdout + res.stderr).splitlines()
           if "registers" in line]
    fn = ctypes.CDLL(str(so)).dccl_cross_coords
    fn.argtypes = CROSS_COORDS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, log


def measure(fn, size, scales, device) -> float:
    """Queued ms of one launch at ``size``'s grids and centres, after a
    bitwise check against the plain version."""
    cen_A, cen_B, grid_A, grid_B = gw.inputs(device, size=size)
    N, L = cen_A.shape[0], len(scales)
    Hg, Wg, _ = grid_A.shape
    outs = torch.empty((4, L * N, 81), device=device).unbind(0)
    arr = (ctypes.c_float * L)(*scales)

    def call():
        status = fn(L, cen_A.data_ptr(), cen_B.data_ptr(), grid_A.data_ptr(),
                    grid_B.data_ptr(), *(o.data_ptr() for o in outs), N, Hg,
                    Wg, arr, torch.cuda.current_stream().cuda_stream)
        _build.check(status, "dccl_cross_coords")

    call()
    ref = dccl_cross_coords_plain(cen_A, cen_B, grid_A, grid_B, scales)
    if not all(torch.equal(o, r) for o, r in zip(outs, ref)):
        raise RuntimeError("a variant is not bitwise its plain version")
    return queued_ms(call, 50)


def run(device) -> dict:
    rec = {}
    for blocks in BLOCKS:
        fn, log = build(blocks)
        rec[blocks] = {"ptxas": log, **{
            f"{name}_ms": measure(fn, size, scales, device)
            for name, (size, scales) in CALLS.items()}}
    return rec


def main() -> None:
    dev = resolve_device()
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"blocks_per_sm": run(dev)}), flush=True)


if __name__ == "__main__":
    main()
