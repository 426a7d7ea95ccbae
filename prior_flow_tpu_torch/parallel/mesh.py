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

The ``space`` axis (JAX's height sharding, ``make_mesh_2d`` with
``space > 1``) needs a design of its own in torch, which has no SPMD
partitioner: ROADMAP Queue 1, item 9b. Meshes with ``space == 1`` work.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# covers a rank-0 validation or checkpoint write while the other ranks
# wait in the next collective
TIMEOUT = datetime.timedelta(hours=1)
SPACE_ITEM = ("spatial sharding (space > 1) is not in the port: ROADMAP "
              "Queue 1, item 9b")


@dataclass
class Mesh:
    """One rank's view of the mesh: the process group, this rank and the
    world size, this rank's device, and JAX's ``axis_names`` / ``shape``
    (``mesh.shape == {"data": n}``)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = ("data",)
    shape: dict = field(default_factory=dict)

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
    explicit ``shape``, and its space extent must be 1. Returns after a
    barrier: every rank has joined."""
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
    if len(shape) == 2 and shape[1] != 1:
        raise ValueError(f"mesh {shape[0]}x{shape[1]}: {SPACE_ITEM}")
    if shape[0] != n_devices:
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
        mesh.barrier()
    except Exception:
        # e.g. NCCL refusing two ranks on one device: leave no group behind
        dist.destroy_process_group()
        raise
    return mesh


def make_mesh_2d(data: int, space: int, **kwargs) -> Mesh:
    """A ``data`` x ``space`` mesh; ``space`` must be 1 in the port (JAX's
    height sharding is ROADMAP Queue 1, item 9b)."""
    if space != 1:
        raise ValueError(f"mesh {data}x{space}: {SPACE_ITEM}")
    return make_mesh(data, ("data", "space"), (data, space), **kwargs)


def close_mesh(mesh: Mesh) -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n``; raises where ``n`` does
    not divide over the ranks."""
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} does not divide over "
                         f"{mesh.size} ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """``x -> x[rows]``, this rank's rows of dim 0 (JAX's ``P('data')``)."""
    if axis != "data":
        raise ValueError(f"the port shards the batch over 'data', not "
                         f"{axis!r}")
    return lambda x: x[local_rows(x.shape[0], mesh)]


def spatial_batch_sharding(mesh: Mesh):
    """JAX's ``P('data', 'space')``: with ``space == 1`` the batch rows."""
    if mesh.shape.get("space", 1) != 1:
        raise ValueError(SPACE_ITEM)
    return batch_sharding(mesh)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of each tensor of a global batch, on the rank's
    device; other entries (lists of names) pass as they are."""
    rows = batch_sharding(mesh, axis)
    return tuple(rows(x).to(mesh.device) if torch.is_tensor(x) else x
                 for x in batch)


@torch.no_grad()
def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place."""
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
