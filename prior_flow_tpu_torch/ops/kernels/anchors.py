"""Primitive-rate anchors of the card: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterparts of the JAX package's ``tools/microbench_vpu_anchor.py``
kernels; kernel source ``prior_flow_tpu_torch/csrc/microbench_anchor.cu``:

- ``anchor_chain`` (``_kernel``, via ``_build``): ``ilp`` independent
  chains of K dependent selects, in-row gathers or FMAs per element of an
  (R, 128) f32 tile, summed at the end: the rate of the primitive that each
  DCCL stage is made of;
- ``step_cost_copy`` (``_copy_kernel``, via ``_build_step_cost``): o = 2x,
  one (8, 128) f32 tile per block, whose time against the number of blocks
  gives the fixed cost of one block;
- ``launch_empty``: one empty kernel, the cost of a launch. It replaces no
  TPU kernel and has no plain version.

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dccl_lookup import _device_or_plain

LANES = 128
CHAIN_K = 256            # the steps of one chain that the kernel is built for
KINDS = {"select": 0, "gather": 1, "fma": 2}
ILPS = (1, 4)
TILE_ROWS = 8            # rows of one step_cost_copy tile


def _init_scale(j: int) -> float:
    """The f32 factor of chain j's start, x * (0.5 + 0.1 j)."""
    return torch.tensor(0.5 + 0.1 * j, dtype=torch.float32).item()


def _check_chain(kind: str, ilp: int, K: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    if ilp not in ILPS:
        raise ValueError(f"ilp must be one of {ILPS}, got {ilp}")
    if K <= 0 or K % ilp:
        raise ValueError(f"K must be a positive multiple of ilp, got {K}")


def fma_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 ``y * x + x`` with one rounding. The f64 product of two f32 is
    exact; the f64 sum is rounded to odd (a result that is not exact moves
    to its odd neighbour, found from the TwoSum error), and a sum rounded to
    odd at 53 bits rounds to 24 bits as the exact value does. A plain f64
    sum rounded to f32 would round twice and, through the chain's
    cancellation in x * (y + 1), drift several f32 steps from the FFMA."""
    xd = x.double()
    p = y.double() * xd
    s = p + xd
    b = s - p
    e = (p - (s - b)) + (xd - b)
    even = (s.view(torch.int64) & 1) == 0
    move = (e != 0) & even & torch.isfinite(s)
    toward = torch.where(e > 0, float("inf"), float("-inf")).double()
    return torch.where(move, torch.nextafter(s, toward), s).float()


def anchor_chain_plain(x: torch.Tensor, idx: torch.Tensor, kind: str,
                       ilp: int = 1, K: int = CHAIN_K) -> torch.Tensor:
    """x: (R, 128) f32; idx: (R, 128) int32. Chain j starts at
    x * (0.5 + 0.1 j) and takes K/ilp steps; step k is

    - select: ``where((idx & (1 + (k + j) % 7)) != 0, x, y)``;
    - gather: ``y[r, idx[r, c] & 127]`` (a permutation for the tools);
    - fma: ``y * x + x`` rounded once (``fma_f32``), as XLA fuses it and
      the kernel's FFMA computes it.

    Returns ((y_0 + y_1) + ...) as (R, 128) f32."""
    _check_chain(kind, ilp, K)
    ys = [x * _init_scale(j) for j in range(ilp)]
    perm = (idx & (LANES - 1)).long()
    for k in range(K // ilp):
        for j in range(ilp):
            if kind == "select":
                ys[j] = torch.where((idx & (1 + (k + j) % 7)) != 0, x, ys[j])
            elif kind == "gather":
                ys[j] = torch.gather(ys[j], 1, perm)
            else:
                ys[j] = fma_f32(ys[j], x)
    out = ys[0]
    for y in ys[1:]:
        out = out + y
    return out


def step_cost_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """o = 2x: (tiles * 8, 128) f32."""
    return x * 2.0


def _kernel(name: str):
    fn = getattr(_build.load_library().lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {"anchor_chain": [p, p, p, i, i, i, p],
                   "step_cost_copy": [p, p, i, p],
                   "empty_launch": [p]}[name]
    fn.restype = i
    return fn


def _check_tile(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"{name}: x must be (R, {LANES}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def anchor_chain(x: torch.Tensor, idx: torch.Tensor, kind: str, ilp: int = 1,
                 K: int = CHAIN_K) -> torch.Tensor:
    """The chained anchor; same arguments and result as
    ``anchor_chain_plain``. The kernel is built for K = 256 only."""
    if _device_or_plain("anchor_chain", x):
        return anchor_chain_plain(x, idx, kind, ilp, K)
    _check_chain(kind, ilp, K)
    if K != CHAIN_K:
        raise ValueError(f"anchor_chain: the kernel runs K = {CHAIN_K}, got {K}")
    _check_tile("anchor_chain", x)
    if idx.shape != x.shape or idx.dtype != torch.int32 \
            or idx.device != x.device or not idx.is_contiguous():
        raise ValueError(f"anchor_chain: idx must be contiguous int32 of x's "
                         f"shape and device, got {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel("anchor_chain")(x.data_ptr(), idx.data_ptr(),
                                         out.data_ptr(), x.shape[0],
                                         KINDS[kind], ilp, stream)
    _build.check(status, "anchor_chain")
    anchor_chain.launches += 1
    return out


anchor_chain.launches = 0


def step_cost_copy(x: torch.Tensor) -> torch.Tensor:
    """o = 2x, one (8, 128) tile per block; same as
    ``step_cost_copy_plain``."""
    if _device_or_plain("step_cost_copy", x):
        return step_cost_copy_plain(x)
    _check_tile("step_cost_copy", x)
    if x.shape[0] % TILE_ROWS:
        raise ValueError(f"step_cost_copy: rows must be a multiple of "
                         f"{TILE_ROWS}, got {x.shape[0]}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel("step_cost_copy")(x.data_ptr(), out.data_ptr(),
                                           x.shape[0] // TILE_ROWS, stream)
    _build.check(status, "step_cost_copy")
    step_cost_copy.launches += 1
    return out


step_cost_copy.launches = 0


def launch_empty(device: torch.device) -> None:
    """One empty kernel on ``device``'s current stream."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_kernel("empty_launch")(stream), "launch_empty")
