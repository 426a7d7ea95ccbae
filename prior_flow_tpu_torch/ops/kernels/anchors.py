"""Primitive-rate anchors of the card: the CUDA kernels' wrappers and their
plain PyTorch versions.

Counterparts of the JAX package's ``tools/microbench_vpu_anchor.py``
kernels; kernel source ``prior_flow_tpu_torch/csrc/microbench_anchor.cu``:

- ``anchor_chain`` (``_kernel``, via ``_build``): ``ilp`` independent
  chains of K dependent selects, in-row gathers or FMAs per element of an
  (R, 128) f32 tile, summed at the end: the rate of the primitive that each
  DCCL stage is made of. The gather reads the row on a read schedule that
  ``gather_plan`` builds once per index tensor, so that every step's
  shared-memory accesses are free of bank conflicts;
- ``gather_plan``: that schedule, a proper 4-edge-coloring of the lanes'
  gather graph by two Euler splits, one thread per row
  (``gather_plan_plain`` says what it holds);
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
WARP = 32                # lanes of the warp that runs one row
REGS = LANES // WARP     # elements per lane


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


def _completed_permutation(v: torch.Tensor) -> torch.Tensor:
    """v: (R, 128) int64 in [0, 128). v where a value occurs first in its
    row; the later duplicates, in order, take the values the row misses,
    in increasing order. A permutation is returned as it is."""
    ar = torch.arange(LANES, device=v.device).expand_as(v)
    sv, order = torch.sort(v, dim=1, stable=True)
    first_sorted = torch.ones_like(sv, dtype=torch.bool)
    first_sorted[:, 1:] = sv[:, 1:] != sv[:, :-1]
    first = torch.empty_like(first_sorted).scatter_(1, order, first_sorted)
    present = torch.zeros_like(first).scatter_(1, v, True)
    missing = torch.sort(torch.where(present, ar + LANES, ar), dim=1).values
    rank = (torch.cumsum((~first).long(), dim=1) - 1).clamp(min=0)
    return torch.where(first, v, missing.gather(1, rank))


def _euler_split(ends_a: torch.Tensor, ends_b: torch.Tensor) -> torch.Tensor:
    """One Euler split of each row's E edges; edge e joins vertex
    ends_a[e] on one side to ends_b[e] on the other, (R, E) int64, every
    vertex of even degree. Closed trails, each started at the lowest
    unused edge from its a-end and continued at each vertex by the vertex's
    lowest unused edge, end when they come back to their first vertex.
    Returns (R, E) int64: 1 for an edge walked from its b-end to its a-end,
    else 0; each vertex has as many edges of each."""
    R, E = ends_a.shape
    ar = torch.arange(E, device=ends_a.device)
    rows = torch.arange(R, device=ends_a.device)
    used = torch.zeros(R, E, dtype=torch.bool, device=ends_a.device)
    back = torch.zeros(R, E, dtype=torch.long, device=ends_a.device)
    open_ = torch.zeros(R, dtype=torch.bool, device=ends_a.device)
    at_a = torch.ones_like(open_)
    cur = torch.zeros(R, dtype=torch.long, device=ends_a.device)
    v0 = torch.zeros_like(cur)
    for _ in range(E):
        here = torch.where(at_a[:, None], ends_a, ends_b) == cur[:, None]
        cand = ~used & (here | ~open_[:, None])
        e = torch.where(cand, ar, E).min(dim=1).values
        walk_back = open_ & ~at_a
        v0 = torch.where(open_, v0, ends_a[rows, e])
        used[rows, e] = True
        back[rows, e] = walk_back.long()
        cur = torch.where(walk_back, ends_a[rows, e], ends_b[rows, e])
        open_ = ~(walk_back & (cur == v0))
        at_a = walk_back
    return back


def gather_plan_plain(idx: torch.Tensor) -> torch.Tensor:
    """idx: (R, 128) int32. The gather chain's read schedule, (R, 32, 4, 2)
    uint8: plan[r, l, k] = (the element c that lane l holds in register k,
    the shared-memory word its source idx[r, c] & 127 is stored at).

    Element c belongs to lane c % 32; within its lane it takes register
    color(c), where color is a proper 4-edge-coloring of the bipartite
    multigraph with an edge from lane c % 32 to lane pi[c] % 32 for every
    c (two Euler splits: the first halves the edges, the second halves
    each half). pi is idx & 127 completed to a permutation
    (``_completed_permutation``), so every lane holds each register once;
    for a permutation idx every register's 32 sources lie in 32 distinct
    lanes. Register k of lane l is stored at word 32 k + l, so the source
    word of element c is 32 color(v) + v % 32 with v = idx[c] & 127:
    within one register the banks are the source lanes, conflict-free.
    The kernel builds the same bytes."""
    v = (idx & (LANES - 1)).long()
    pi = _completed_permutation(v)
    lane = torch.arange(LANES, device=idx.device).expand_as(v) % WARP
    half1 = _euler_split(lane, pi % WARP)
    half2 = _euler_split(half1 * WARP + lane, half1 * WARP + pi % WARP)
    color = 2 * half1 + half2
    slot = lane * REGS + color
    elems = torch.arange(LANES, device=idx.device).expand_as(v)
    src = WARP * color.gather(1, v) + v % WARP
    plan = torch.stack([torch.empty_like(v).scatter_(1, slot, elems),
                        torch.empty_like(v).scatter_(1, slot, src)], -1)
    return plan.to(torch.uint8).reshape(-1, WARP, REGS, 2)


def slot_words() -> torch.Tensor:
    """(32, 4) int64: the shared-memory word that lane l's register k is
    stored at, 32 k + l."""
    return (torch.arange(REGS) * WARP)[None, :] + torch.arange(WARP)[:, None]


def gather_chain_scheduled_plain(x: torch.Tensor, plan: torch.Tensor,
                                 ilp: int = 1, K: int = CHAIN_K):
    """The gather chain as the kernel runs it on ``plan``, in PyTorch:
    registers loaded from x at the plan's elements, each step a store of
    register k of lane l at word 32 k + l and a load of every register
    from its source word, the sum stored at the elements. Bitwise
    ``anchor_chain_plain(x, idx, "gather", ilp, K)`` for
    ``plan = gather_plan_plain(idx)``."""
    _check_chain("gather", ilp, K)
    R = x.shape[0]
    elem = plan[..., 0].long().reshape(R, LANES)
    src = plan[..., 1].long().reshape(R, LANES)
    words = slot_words().reshape(-1).to(x.device)
    ys = [x.gather(1, elem) * _init_scale(j) for j in range(ilp)]
    for _ in range(K // ilp):
        for j in range(ilp):
            buf = torch.empty_like(ys[j])
            buf[:, words] = ys[j]
            ys[j] = buf.gather(1, src)
    out = ys[0]
    for y in ys[1:]:
        out = out + y
    return torch.empty_like(x).scatter_(1, elem, out)


def step_cost_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """o = 2x: (tiles * 8, 128) f32."""
    return x * 2.0


def _kernel(name: str):
    fn = getattr(_build.load_library().lib, name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {"anchor_chain": [p, p, p, i, i, i, p],
                   "gather_plan": [p, p, i, p],
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


def _check_idx(name: str, idx: torch.Tensor, x: torch.Tensor) -> None:
    if idx.shape != x.shape or idx.dtype != torch.int32 \
            or idx.device != x.device or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous int32 of shape "
                         f"{tuple(x.shape)} on {x.device}, got "
                         f"{tuple(idx.shape)} {idx.dtype} on {idx.device}")


def gather_plan(idx: torch.Tensor) -> torch.Tensor:
    """The gather chain's read schedule of ``idx``; same argument and
    result as ``gather_plan_plain``."""
    if _device_or_plain("gather_plan", idx):
        return gather_plan_plain(idx)
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != LANES \
            or not idx.is_contiguous():
        raise ValueError(f"gather_plan: idx must be contiguous (R, {LANES}) "
                         f"int32, got {tuple(idx.shape)} {idx.dtype}")
    plan = torch.empty((idx.shape[0], WARP, REGS, 2), dtype=torch.uint8,
                       device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel("gather_plan")(idx.data_ptr(), plan.data_ptr(),
                                        idx.shape[0], stream)
    _build.check(status, "gather_plan")
    gather_plan.launches += 1
    return plan


gather_plan.launches = 0


def anchor_chain(x: torch.Tensor, idx: torch.Tensor, kind: str, ilp: int = 1,
                 K: int = CHAIN_K, plan: torch.Tensor | None = None):
    """The chained anchor; same arguments and result as
    ``anchor_chain_plain``. The kernel is built for K = 256 only. The
    gather runs on ``plan``, ``gather_plan(idx)``'s schedule, which is
    built here (one more launch) when it is not given; the plain version
    needs none."""
    if _device_or_plain("anchor_chain", x):
        return anchor_chain_plain(x, idx, kind, ilp, K)
    _check_chain(kind, ilp, K)
    if K != CHAIN_K:
        raise ValueError(f"anchor_chain: the kernel runs K = {CHAIN_K}, got {K}")
    _check_tile("anchor_chain", x)
    _check_idx("anchor_chain", idx, x)
    aux = idx
    if kind == "gather":
        aux = gather_plan(idx) if plan is None else plan
        if aux.shape != (x.shape[0], WARP, REGS, 2) \
                or aux.dtype != torch.uint8 or aux.device != x.device \
                or not aux.is_contiguous():
            raise ValueError(f"anchor_chain: plan must be contiguous uint8 "
                             f"({x.shape[0]}, {WARP}, {REGS}, 2) on "
                             f"{x.device}, got {tuple(aux.shape)} "
                             f"{aux.dtype} on {aux.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _kernel("anchor_chain")(x.data_ptr(), aux.data_ptr(),
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
