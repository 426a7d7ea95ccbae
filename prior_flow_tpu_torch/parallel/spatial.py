"""Height sharding over the ``space`` axis (the port's counterpart of
JAX's ``P('data', 'space')`` on ``prior_flow_tpu/parallel/mesh.py::
make_mesh_2d``).

JAX shards the inputs' height over the ``space`` devices and XLA's SPMD
partitioner inserts every halo exchange and gather. Torch has none, so the
port makes each cross-row exchange itself, each differentiable:

- ``gather_rows(x, dim)``: the whole image of which every rank holds a
  strip, concatenated along ``dim`` without the pad rows (an all-gather
  within the space group); its backward is a reduce-scatter, each rank's
  rows getting the sum of every rank's cotangents, its pad rows zero;
- ``halo_rows(x, top, bottom, dim)``: this rank's rows with ``top`` rows
  above and ``bottom`` below, zero beyond the image (its own pad rows
  too), taken from whichever ranks own them (a halo may be wider than one
  rank's rows); its backward adds each halo row's cotangent into its
  owner's row;
- ``sum_over_space(t)``: an all-reduce (not differentiable: the
  instance norm's sums, inside its own autograd Function);
- ``summed(t, batch)``: a differentiable all-reduce, over the space group
  (the group norm's per-sample sums) or, with ``batch``, over every rank
  that holds rows of the global batch (the batch-statistics BatchNorm's
  sums, ``Space.data`` > 1 on a mesh with a data axis); its backward
  sums the cotangents over the same ranks.

The sharded code runs inside ``scope(space)``: the convolutions, the
instance norm, the warps, the static resamples, the model and the loss
read ``current()`` and shard only where it is set; outside it no code
path changes. The state is the call's, not the modules': a validation of
rank 0 outside the scope runs the unsharded forward on whole images. The
scope is process-wide, not per thread, because autograd runs a card's
backward (and the checkpoint regions' recomputes inside it) on a thread
of its own. A scope whose ``Space`` has one rank of height (S = 1) and
several data ranks shards nothing: it only sums the batch-statistics
BatchNorm's statistics over the data ranks (``current(batch=True)``), as
JAX's jitted apply on a ``P('data')`` batch does.

Strips. Every height JAX's ``P('data', 'space')`` takes shards: H a
multiple of 8 (the model's 1/8 grid) and of S (``jax.device_put``'s
rule), ``check_height``. Space rank r holds the strip of full-resolution
rows ``[r * n, (r + 1) * n)``, n = 8 * ceil(H / (8 S)) (``strip_rows``),
a multiple of 8, so its strip at 1/2, 1/4 and 1/8 resolution is n / 2,
n / 4 and n / 8 rows from row r * n / f. The rows past H are pad rows:
the last strips hold some, a strip may hold nothing else (H / 8 = 9 over
S = 4 gives strips of 3, the last all padding), as JAX pads the last
devices. A rank is handed, and returns, its real rows only
(``shard_rows``): the ranks' rows concatenated in rank order are the
whole image. The model pads them to the strip on entry (``Space.pad``)
and cuts its outputs back (``Space.crop``); inside, every tensor with a
height holds the rank's strip. The geometry, the whole image's height
``Space.height``, is set once per forward or training step from the
inputs (``enter``: one all-gather of each rank's row count) and stays on
the scope until it ends, for the backward's recomputes. A ``Space``
without it (``height`` None) splits evenly and holds no pad rows.

Pad rows behave as if absent: every cross-row reader skips them
(``gather_rows`` drops them, ``halo_rows`` reads them as zero, the
norms sum real rows only, ``rows`` pads grids with zeros that no real
row reads), so no real row reads a pad row and no pad row receives a
cotangent; what a pad row holds (convolution biases, the samples of a
zero grid) never reaches a real one. The width (ERP longitude) is never
split. Coordinates and centres stay in global pixels; grids stay whole
on every rank and are read at the rank's strip (``rows``).

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
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def strip_rows(H: int, size: int) -> int:
    """Full-resolution rows of each rank's strip of an image of ``H`` rows
    over ``size`` space ranks: 8 * ceil(H / (8 * size))."""
    return 8 * -(-H // (8 * size))


@dataclass(frozen=True)
class Space:
    """One rank's view of its space group: the group (None: the default
    group), this rank's index in it, its size and the backend; ``data``,
    the data ranks of the mesh, and ``mesh_group``, the group of all
    ``data * size`` ranks (None: the default group), over which the batch
    statistics are summed where ``data`` > 1; ``height``, the whole
    image's full-resolution rows of the current forward or step (None:
    an even split without pad rows; ``enter`` sets it)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    backend: str
    data: int = 1
    mesh_group: Optional[dist.ProcessGroup] = None
    height: Optional[int] = None

    @property
    def route(self) -> str:
        """The collectives the exchanges take, on this backend."""
        return f"{self.backend}: all_gather_into_tensor, reduce_scatter_tensor"

    @property
    def strip(self) -> int:
        """This forward's full-resolution strip rows (``strip_rows``)."""
        return strip_rows(self.height, self.size)

    def whole(self, h: int) -> int:
        """The whole image's rows at the resolution of an ``h``-row strip."""
        if self.height is None:
            return h * self.size
        return self.height * h // self.strip

    def strip_of(self, whole: int) -> int:
        """The strip rows at the resolution of a ``whole``-row image."""
        if self.height is None:
            return whole // self.size
        return self.strip * whole // self.height

    def real(self, h: int) -> int:
        """The real (not pad) rows of this rank's ``h``-row strip."""
        return min(h, max(0, self.whole(h) - self.rank * h))

    def pad(self, x: torch.Tensor, dim: int, scale: int = 1) -> torch.Tensor:
        """This rank's real rows of a 1/``scale``-resolution tensor ->
        its strip, the pad rows zero."""
        return pad_rows(x, dim, self.strip // scale)

    def crop(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's strip -> its real rows."""
        return x.narrow(dim, 0, self.real(x.shape[dim]))

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
        if batch and self.data > 1:
            group = self.mesh_group
        elif self.size == 1:
            return t
        else:
            group = self.group
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t


_current: Optional[Space] = None


def current(batch: bool = False) -> Optional[Space]:
    """The ``Space`` of the innermost ``scope`` where it shards the height
    (S > 1), else None; with ``batch`` also where it only spans several
    data ranks (the batch statistics' sums)."""
    if _current is None:
        return None
    if _current.size > 1 or (batch and _current.data > 1):
        return _current
    return None


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
    """Raises unless ``H`` is a height JAX shards over ``size`` space
    devices: a multiple of 8, as the unsharded model needs, and of
    ``size``, as ``jax.device_put`` needs of ``P('data', 'space')``."""
    if H % 8:
        raise ValueError(f"height {H} is not a multiple of 8: the model "
                         f"runs on a 1/8 grid of the image")
    if H % size:
        raise ValueError(f"height {H} does not split over {size} space "
                         f"ranks: the global size of the height dimension "
                         f"should be divisible by {size}, as jax.device_put "
                         f"requires of P('data', 'space')")


def layout(H: int, size: int) -> list:
    """Each space rank's real full-resolution rows of an ``H``-row image."""
    n = strip_rows(H, size)
    return [min(n, max(0, H - q * n)) for q in range(size)]


def geometry(space: Space, rows: int, device) -> Space:
    """``space`` with the height of the image of which this rank holds
    ``rows`` full-resolution rows: one all-gather of the ranks' counts (a
    collective: every rank of the group calls it). Raises, on every rank
    alike, where the whole height is not one ``check_height`` takes or
    the counts are not its strips' real rows (``shard_rows``)."""
    counts = space.gather_stack(torch.tensor(
        [rows], dtype=torch.int64, device=device)).view(-1).tolist()
    H = sum(counts)
    check_height(H, space.size)
    if counts != layout(H, space.size):
        raise ValueError(f"the space ranks hold {counts} rows of a "
                         f"{H}-row image, not its strips' "
                         f"{layout(H, space.size)} (shard_rows)")
    return dataclasses.replace(space, height=H)


def enter(rows: int, device) -> Space:
    """Set the current scope's height from this rank's ``rows`` (the
    forward's or the step's inputs, ``geometry``) until the scope ends,
    and return its ``Space``."""
    global _current
    _current = geometry(current(), rows, device)
    return _current


def pad_rows(x: torch.Tensor, dim: int, h: int) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to ``h``."""
    n = x.shape[dim]
    if n == h:
        return x
    shape = list(x.shape)
    shape[dim] = h - n
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def shard_rows(t: torch.Tensor, space: Space, dim: int = 1) -> torch.Tensor:
    """Space rank r's real rows of the whole image ``t`` (along ``dim``):
    ``[r * n, min((r + 1) * n, H))`` of its H rows, n = ``strip_rows``
    (none where the strip is all padding)."""
    H = t.shape[dim]
    n = strip_rows(H, space.size)
    start = min(space.rank * n, H)
    return t.narrow(dim, start, min(n, H - start))


def rows(t: torch.Tensor, space: Space, dim: int = 0) -> torch.Tensor:
    """Space rank r's strip of the whole ``t`` along ``dim`` (a grid's, or
    an image's, rows at any of the strips' resolutions), its pad rows
    zero."""
    h = space.strip_of(t.shape[dim])
    start = min(space.rank * h, t.shape[dim])
    return pad_rows(t.narrow(dim, start, space.real(h)), dim, h)


def identity_rows(h: int, w: int, device, space: Space) -> torch.Tensor:
    """The (h, w, 2) rows of the global identity pixel grid in this rank's
    strip: y offset by its first row, x = column."""
    y, x = torch.meshgrid(
        torch.arange(space.rank * h, (space.rank + 1) * h,
                     dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space: Space, dim: int):
        ctx.space, ctx.dim, ctx.h = space, dim, x.shape[dim]
        whole = torch.cat(space.gather_stack(x).unbind(0), dim=dim)
        return whole.narrow(dim, 0, space.whole(x.shape[dim]))

    @staticmethod
    def backward(ctx, g):
        space, dim = ctx.space, ctx.dim
        g = pad_rows(g, dim, space.size * ctx.h)
        stacked = torch.stack(g.chunk(space.size, dim=dim))
        return space.reduce_scatter(stacked), None, None


def gather_rows(x: torch.Tensor, dim: int = 1,
                space: Optional[Space] = None) -> torch.Tensor:
    """The whole image of which ``x`` holds this rank's strip (along
    ``dim``), without pad rows; differentiable."""
    return _GatherRows.apply(x, space or current(), dim)


def _halo_plan(n: int, top: int, bottom: int, rank: int, whole: int):
    """Rank ``rank``'s halo rows, the ``top`` above then the ``bottom``
    below: per row None (beyond the ``whole`` image's rows, pad rows
    included: zero) or (owner, index in the owner's strip), a strip being
    a rank's last min(top, n) rows then its first min(bottom, n)."""
    t, i0 = min(top, n), rank * n
    plan = []
    for j in [*range(i0 - top, i0), *range(i0 + n, i0 + n + bottom)]:
        if not 0 <= j < whole:
            plan.append(None)
            continue
        q, loc = divmod(j, n)
        plan.append((q, loc - (n - t) if j < i0 else t + loc))
    return plan


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space: Space, top: int, bottom: int, dim: int):
        n = x.shape[dim]
        t, b, whole = min(top, n), min(bottom, n), space.whole(n)
        ctx.space, ctx.args = space, (top, bottom, dim, n)
        strips = space.gather_stack(torch.cat(
            [x.narrow(dim, n - t, t), x.narrow(dim, 0, b)], dim=dim))
        zero = x.new_zeros(x.narrow(dim, 0, 1).shape)
        halo = [zero if p is None else strips[p[0]].narrow(dim, p[1], 1)
                for p in _halo_plan(n, top, bottom, space.rank, whole)]
        own = pad_rows(x.narrow(dim, 0, space.real(n)), dim, n)
        return torch.cat([*halo[:top], own, *halo[top:]], dim=dim)

    @staticmethod
    def backward(ctx, g):
        space, (top, bottom, dim, n) = ctx.space, ctx.args
        t, whole = min(top, n), space.whole(n)
        g_own = pad_rows(g.narrow(dim, top, space.real(n)).clone(), dim, n)
        g_halo = space.gather_stack(torch.cat(
            [g.narrow(dim, 0, top), g.narrow(dim, top + n, bottom)],
            dim=dim))
        for q in range(space.size):
            plan = _halo_plan(n, top, bottom, q, whole)
            for k, p in enumerate(plan):
                if p is None or p[0] != space.rank:
                    continue
                row = n - t + p[1] if p[1] < t else p[1] - t
                g_own.narrow(dim, row, 1).add_(g_halo[q].narrow(dim, k, 1))
        return g_own, None, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, dim: int = 2,
              space: Optional[Space] = None) -> torch.Tensor:
    """This rank's strip of ``x`` (along ``dim``) with ``top`` rows above
    and ``bottom`` below, from the ranks that own them, zero beyond the
    image and on the pad rows (the strip's own too); differentiable."""
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
