"""Height sharding over the ``space`` axis (the port's counterpart of
JAX's ``P('data', 'space')`` on ``prior_flow_tpu/parallel/mesh.py::
make_mesh_2d``).

JAX shards the inputs' height over the ``space`` devices and XLA's SPMD
partitioner inserts every halo exchange and gather. Torch has none, so the
port makes each cross-row exchange itself, each differentiable:

- ``gather_rows(x, dim)``: every rank's rows, concatenated along ``dim``
  (an all-gather within the space group); its backward is a
  reduce-scatter, each rank's rows getting the sum of every rank's
  cotangents;
- ``halo_rows(x, top, bottom, dim)``: this rank's rows with ``top`` rows
  above and ``bottom`` below, zero beyond the image, taken from whichever
  ranks own them (a halo may be wider than one rank's rows); its backward
  adds each halo row's cotangent into its owner's row;
- ``sum_over_space(t)``: an all-reduce (not differentiable: the
  instance norm's sums, inside its own autograd Function);
- ``summed(t, batch)``: a differentiable all-reduce, over the space group
  (the group norm's per-sample sums) or, with ``batch``, over every rank
  that holds rows of the global batch (the batch-statistics BatchNorm's
  sums, ``Space.data`` > 1 on a mesh with a data axis too); its backward
  sums the cotangents over the same ranks.

The sharded code runs inside ``scope(space)``: the convolutions, the
instance norm, the warps, the static resamples, the model and the loss
read ``current()`` and shard only where it is set; outside it no code
path changes. The state is the call's, not the modules': a validation of
rank 0 outside the scope runs the unsharded forward on whole images. The
scope is process-wide, not per thread, because autograd runs a card's
backward (and the checkpoint regions' recomputes inside it) on a thread
of its own.

Every rank of a space group holds ``H / S`` rows at full resolution, a
multiple of 8 (``check_height``: ``H / 8 % S == 0``), the rows
``[r * H / S, (r + 1) * H / S)`` of space rank r; the width (ERP
longitude) is never split. Coordinates and centres stay in global
pixels; grids stay whole on every rank and are read at the rank's rows
(``rows``).

Exchange route (``Space.route``, printed by ``chip_smoke.py`` phase 25):
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on either
backend, with no fallback. NCCL (one rank per card) has both. gloo (the
CPU, or ranks sharing one card, which NCCL refuses) takes both for CPU
tensors and, on the H100 host's torch 2.11, for CUDA tensors too (it
stages them through the host; ``chip_smoke.py`` phase 25 runs two gloo
ranks on one card); so the gather needs no all-reduce of a zero-filled
buffer.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

@dataclass(frozen=True)
class Space:
    """One rank's view of its space group: the group (None: the default
    group), this rank's index in it, its size and the backend; ``data``,
    the data ranks of the mesh, and ``mesh_group``, the group of all
    ``data * size`` ranks (None: the default group), over which the batch
    statistics are summed where ``data`` > 1."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    backend: str
    data: int = 1
    mesh_group: Optional[dist.ProcessGroup] = None

    @property
    def route(self) -> str:
        """The collectives the exchanges take, on this backend."""
        return f"{self.backend}: all_gather_into_tensor, reduce_scatter_tensor"

    def gather_stack(self, x: torch.Tensor) -> torch.Tensor:
        """(S, *x.shape): every rank's ``x`` in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.numel(),))
        dist.all_gather_into_tensor(out, x.reshape(-1), group=self.group)
        return out.view(self.size, *x.shape)

    def reduce_scatter(self, stacked: torch.Tensor) -> torch.Tensor:
        """stacked (S, ...): slice ``rank`` of the sum over the ranks."""
        stacked = stacked.contiguous()
        out = stacked.new_empty((stacked[0].numel(),))
        dist.reduce_scatter_tensor(out, stacked.reshape(-1), group=self.group)
        return out.view(stacked.shape[1:])

    def all_reduce_(self, t: torch.Tensor, batch: bool = False):
        """SUM over the space group, in place; with ``batch`` over every
        rank that holds rows of the global batch."""
        group = self.mesh_group if batch and self.data > 1 else self.group
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


_current: Optional[Space] = None


def current() -> Optional[Space]:
    """The ``Space`` of the innermost ``scope``, else None."""
    return _current


@contextlib.contextmanager
def scope(space: Optional[Space]):
    """Run the model, the loss and their backward height-sharded over
    ``space`` (None: unsharded)."""
    global _current
    prev, _current = _current, space
    try:
        yield space
    finally:
        _current = prev


def check_height(H: int, size: int) -> None:
    """Raises unless ``H`` splits into ``size`` slices of whole 1/8 rows."""
    if H % 8 or (H // 8) % size:
        raise ValueError(f"height {H} does not split over {size} space "
                         f"ranks: H / 8 must divide by the space axis "
                         f"(H / 8 % S == 0)")


def rows(t: torch.Tensor, space: Space, dim: int = 0) -> torch.Tensor:
    """Space rank r's slice r of ``size`` equal slices of ``t`` along
    ``dim`` (a whole grid's, or a whole image's, rows)."""
    n = t.shape[dim] // space.size
    return t.narrow(dim, space.rank * n, n)


def identity_rows(h: int, w: int, device, space: Space) -> torch.Tensor:
    """The (h, w, 2) rows of the global identity pixel grid that this rank
    holds: y offset by its first row, x = column."""
    y, x = torch.meshgrid(
        torch.arange(space.rank * h, (space.rank + 1) * h,
                     dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space: Space, dim: int):
        ctx.space, ctx.dim = space, dim
        return torch.cat(space.gather_stack(x).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        space, dim = ctx.space, ctx.dim
        stacked = torch.stack(g.chunk(space.size, dim=dim))
        return space.reduce_scatter(stacked), None, None


def gather_rows(x: torch.Tensor, dim: int = 1,
                space: Optional[Space] = None) -> torch.Tensor:
    """The whole image of which ``x`` holds this rank's rows (along
    ``dim``); differentiable."""
    return _GatherRows.apply(x, space or current(), dim)


def _halo_plan(n: int, top: int, bottom: int, rank: int, size: int):
    """Rank ``rank``'s halo rows, the ``top`` above then the ``bottom``
    below: per row None (beyond the image: zero) or (owner, index in the
    owner's strip), a strip being a rank's last min(top, n) rows then its
    first min(bottom, n)."""
    t, i0 = min(top, n), rank * n
    plan = []
    for j in [*range(i0 - top, i0), *range(i0 + n, i0 + n + bottom)]:
        if not 0 <= j < size * n:
            plan.append(None)
            continue
        q, loc = divmod(j, n)
        plan.append((q, loc - (n - t) if j < i0 else t + loc))
    return plan


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space: Space, top: int, bottom: int, dim: int):
        n = x.shape[dim]
        t, b = min(top, n), min(bottom, n)
        ctx.space, ctx.args = space, (top, bottom, dim, n)
        strips = space.gather_stack(torch.cat(
            [x.narrow(dim, n - t, t), x.narrow(dim, 0, b)], dim=dim))
        zero = x.new_zeros(x.narrow(dim, 0, 1).shape)
        halo = [zero if p is None else strips[p[0]].narrow(dim, p[1], 1)
                for p in _halo_plan(n, top, bottom, space.rank, space.size)]
        return torch.cat([*halo[:top], x, *halo[top:]], dim=dim)

    @staticmethod
    def backward(ctx, g):
        space, (top, bottom, dim, n) = ctx.space, ctx.args
        t = min(top, n)
        g_own = g.narrow(dim, top, n).clone()
        g_halo = space.gather_stack(torch.cat(
            [g.narrow(dim, 0, top), g.narrow(dim, top + n, bottom)],
            dim=dim))
        for q in range(space.size):
            plan = _halo_plan(n, top, bottom, q, space.size)
            for k, p in enumerate(plan):
                if p is None or p[0] != space.rank:
                    continue
                row = n - t + p[1] if p[1] < t else p[1] - t
                g_own.narrow(dim, row, 1).add_(g_halo[q].narrow(dim, k, 1))
        return g_own, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, dim: int = 2,
              space: Optional[Space] = None) -> torch.Tensor:
    """This rank's rows of ``x`` (along ``dim``) with ``top`` rows above
    and ``bottom`` below, from the ranks that own them, zero beyond the
    image; differentiable."""
    return _HaloRows.apply(x, space or current(), top, bottom, dim)


@torch.no_grad()
def sum_over_space(t: torch.Tensor, space: Optional[Space] = None):
    """``t`` summed over the space group, in place (not differentiable)."""
    return (space or current()).all_reduce_(t)


class _Summed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, space: Space, batch: bool):
        ctx.space, ctx.batch = space, batch
        return space.all_reduce_(t.clone(), batch)

    @staticmethod
    def backward(ctx, g):
        # every rank's output is the same sum of every rank's input: each
        # input's cotangent is the sum of the outputs' cotangents
        return ctx.space.all_reduce_(g.contiguous().clone(), ctx.batch), \
            None, None


def summed(t: torch.Tensor, batch: bool = False,
           space: Optional[Space] = None) -> torch.Tensor:
    """``t`` summed over the space group, or with ``batch`` over every rank
    of the global batch; differentiable (the backward sums the
    cotangents over the same ranks)."""
    return _Summed.apply(t, space or current(), batch)
