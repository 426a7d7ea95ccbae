"""Process-group mesh and batch sharding (counterpart of
``prior_flow_tpu/parallel/mesh.py``).

JAX builds one SPMD program over a ``jax.sharding.Mesh``: parameters
replicated, the batch sharded over the ``data`` axis, the gradient
all-reduce inserted by XLA. The port runs one process per rank, each on
its own device, joined by a ``torch.distributed`` process group:

- every rank holds the whole model (``replicated`` broadcasts rank 0's
  parameters and buffers) and takes its rows of each global batch
  (``batch_sharding`` / ``shard_batch``);
- the train step all-reduces the gradients as one flat bucket with SUM
  (``all_reduce_grads``), because the loss is a sum over pixels and batch:
  each rank then holds the global batch's gradients and takes the same
  clip and AdamW update;
- metrics travel as numerators and denominators (``all_reduce_sums``),
  so a ratio is the global batch's, not a mean of per-rank ratios.

No ``DistributedDataParallel``: the taped mode fills ``.grad`` in two
backward passes, which DDP's reducer would reduce at the first, and DDP
averages where the sum is wanted.

Rendezvous comes from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
an explicit ``init_method`` (a ``file://`` path lets processes that share
a host meet without a TCP port). Backend: NCCL on the card, gloo on the
CPU; gloo also on the card where ranks share one device, which NCCL
refuses. Nothing falls back: a failed rendezvous or collective raises.

A 2-D ``data`` x ``space`` mesh (``make_mesh_2d``) lays rank
``d * S + s`` at data index d and space index s, as JAX's device array
``reshape(data, space)`` does, and adds the subgroups: the ``space``
group of the S ranks that share data index d (they hold the height
slices of the same batch rows, ``parallel/spatial.py``) and the ``data``
group of the D ranks that share space index s. The gradient and metric
sums stay over all ranks: each rank's loss is a disjoint share of the
global sum over batch and pixels.
"""

from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .spatial import Space, check_height, shard_rows

# covers a rank-0 validation or checkpoint write while the other ranks
# wait in the next collective
TIMEOUT = datetime.timedelta(hours=1)


@dataclass
class Mesh:
    """One rank's view of the mesh: the process group, this rank and the
    world size, this rank's device, and JAX's ``axis_names`` / ``shape``
    (``mesh.shape == {"data": n}``, or ``{"data": D, "space": S}``).
    ``space``: this rank's space group where S > 1 (else None);
    ``data_group``: its data group where D > 1 and S > 1 (else the whole
    group serves)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = ("data",)
    shape: dict = field(default_factory=dict)
    space: Optional[Space] = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def step_space(self) -> Optional[Space]:
        """The ``spatial.Space`` a training step runs under: ``space``
        where S > 1; on a data-only mesh of several ranks one of a single
        height slice, which shards nothing and sums the batch-statistics
        BatchNorm's statistics over every rank (JAX's jitted apply on a
        ``P('data')`` batch); else None."""
        if self.space is not None or self.data_size == 1:
            return self.space
        return Space(None, 0, 1, self.backend, self.data_size, self.group)

    @property
    def space_size(self) -> int:
        return self.shape.get("space", 1)

    @property
    def space_rank(self) -> int:
        return self.rank % self.space_size

    @property
    def data_size(self) -> int:
        return self.size // self.space_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.space_size

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        dist.broadcast(t, src=src, group=self.group)
        return t

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def rank_device(device=None, rank: int = 0) -> torch.device:
    """A rank's device: ``cuda:LOCAL_RANK`` (else ``cuda:rank``) for None or
    ``"cuda"``; any other device as given (``"cpu"``, or ``"cuda:0"`` for
    ranks that share one card). Raises without a card unless the CPU is
    asked for."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        local = _env_int("LOCAL_RANK")
        return torch.device("cuda", rank if local is None else local)
    return torch.device(device)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, *, device=None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              timeout: datetime.timedelta = TIMEOUT) -> Mesh:
    """Join (or reuse) the default process group and return this rank's
    ``Mesh``.

    ``n_devices``: the world size (default ``WORLD_SIZE``); ``rank``
    (default ``RANK``); ``init_method`` (default ``env://``, torchrun's);
    ``device`` as ``rank_device`` reads it; ``backend`` NCCL on the card,
    gloo on the CPU by default. A 2-D ``("data", "space")`` mesh needs an
    explicit ``shape`` (D, S) with D x S ranks; with S > 1 every rank
    joins the subgroups (``Mesh``). Returns after a barrier: every rank
    has joined."""
    axis_names = tuple(axis_names)
    if n_devices is None:
        n_devices = (dist.get_world_size() if dist.is_initialized()
                     else _env_int("WORLD_SIZE"))
    if n_devices is None:
        raise ValueError("make_mesh needs a world size: run under torchrun "
                         "or pass n_devices")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("explicit shape required for >1 mesh axes")
        shape = (n_devices,)
    shape = tuple(int(s) for s in shape)
    if axis_names not in (("data",), ("data", "space")) or \
            len(shape) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names} of shape {shape}: the port "
                         f"has ('data',) and ('data', 'space')")
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} does not cover {n_devices} "
                         f"ranks")
    if dist.is_initialized():
        rank = dist.get_rank()
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the process group has "
                             f"{dist.get_world_size()} ranks, not "
                             f"{n_devices}")
    elif rank is None:
        rank = _env_int("RANK")
        if rank is None:
            raise ValueError("make_mesh needs this process's rank: run "
                             "under torchrun or pass rank")
    dev = rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=n_devices, rank=rank,
                                timeout=timeout)
    mesh = Mesh(None, rank, n_devices, dev, dist.get_backend(), axis_names,
                dict(zip(axis_names, shape)))
    try:
        if mesh.space_size > 1:
            _join_subgroups(mesh)
        mesh.barrier()
    except Exception:
        # e.g. NCCL refusing two ranks on one device: leave no group behind
        dist.destroy_process_group()
        raise
    return mesh


def _join_subgroups(mesh: Mesh) -> None:
    """Every rank creates every space group, then every data group, in
    one order (``dist.new_group`` is collective), and keeps its own."""
    D, S = mesh.data_size, mesh.space_size
    for d in range(D):
        g = dist.new_group(list(range(d * S, (d + 1) * S)))
        if d == mesh.data_rank:
            mesh.space = Space(g, mesh.space_rank, S, mesh.backend, D,
                               mesh.group)
    if D > 1:
        for s in range(S):
            g = dist.new_group(list(range(s, D * S, S)))
            if s == mesh.space_rank:
                mesh.data_group = g


def make_mesh_2d(data: int, space: int, **kwargs) -> Mesh:
    """A ``data`` x ``space`` mesh over ``data * space`` ranks: the batch
    over ``data``, the image height over ``space`` (``make_mesh``'s
    keywords)."""
    return make_mesh(data * space, ("data", "space"), (data, space),
                     **kwargs)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n``: its data group's
    (every space rank of that group shares them); raises where ``n`` does
    not divide over the data axis."""
    if n % mesh.data_size:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{mesh.data_size} data ranks")
    b = n // mesh.data_size
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """``x -> x[rows]``, this rank's rows of dim 0 (JAX's ``P('data')``)."""
    if axis != "data":
        raise ValueError(f"the port shards the batch over 'data', not "
                         f"{axis!r}")
    return lambda x: x[local_rows(x.shape[0], mesh)]


def height_sharding(mesh: Mesh):
    """``x -> `` this rank's real height rows of dim 1 (images (B, H, W,
    3), flows (B, H, W, 2), valid masks (B, H, W)) on a mesh with S > 1
    (``spatial.shard_rows``: the strips of 8 * ceil(H / (8 S)) rows, the
    last ones short or empty), else ``x``; raises where JAX would: H not
    a multiple of 8 or of S (``spatial.check_height``)."""
    if mesh.space is None:
        return lambda x: x

    def shard(x):
        check_height(x.shape[1], mesh.space_size)
        return shard_rows(x, mesh.space, dim=1)

    return shard


def spatial_batch_sharding(mesh: Mesh):
    """JAX's ``P('data', 'space')``: ``x -> `` this rank's batch rows
    (``batch_sharding``) and its height rows (``height_sharding``)."""
    batch_rows, height_rows = batch_sharding(mesh), height_sharding(mesh)
    return lambda x: height_rows(batch_rows(x))


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of each tensor of a global batch, on the rank's
    device (``spatial_batch_sharding`` on a mesh with S > 1); other
    entries (lists of names) pass as they are."""
    rows_of = (spatial_batch_sharding(mesh) if mesh.space is not None
               else batch_sharding(mesh, axis))
    return tuple(rows_of(x).to(mesh.device) if torch.is_tensor(x) else x
                 for x in batch)


@torch.no_grad()
def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank of both axes, in
    place."""
    for t in [*module.parameters(), *module.buffers()]:
        mesh.broadcast_(t.data)
    return module


@torch.no_grad()
def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Mesh) -> int:
    """SUM ``grads`` over the ranks, in place, as one flat bucket per dtype
    (one collective for the f32 gradients of the model). Returns the
    bucket bytes."""
    total = 0
    for dtype in dict.fromkeys(g.dtype for g in grads):
        part = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in part])
        mesh.all_reduce_(flat)
        torch._foreach_copy_(part, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in part]), part)])
        total += flat.numel() * flat.element_size()
    return total


@torch.no_grad()
def all_reduce_sums(values: Sequence[torch.Tensor], mesh: Mesh):
    """0-dim sums (f32 numerators, integer counts) summed over the ranks in
    one float64 collective; each comes back in its own dtype (exact for
    one rank, and for counts below 2^53)."""
    packed = torch.stack([v.detach().double() for v in values])
    mesh.all_reduce_(packed)
    return [p.to(v.dtype) for p, v in zip(packed, values)]
