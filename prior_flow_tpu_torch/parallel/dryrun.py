"""Data-parallel runs over spawned ranks: the port's counterpart of
``__graft_entry__.py::dryrun_multichip`` and the pieces that hold a
data-parallel step to the single-process one.

- ``spawn(fn, n, ...)``: n rank processes (start method ``spawn``, one
  intra-op thread each), meeting through a ``file://`` store in a fresh
  temp directory, each running ``fn(mesh, *args)``; returns their
  results. A rank that raises or dies fails the call (the others are
  stopped), and so does a run past ``timeout_s``: nothing falls back to
  fewer ranks.
- ``dryrun_multichip(n)``: ``Trainer.run`` for 2 updates on n ranks
  (a 2 x n/2 data x space mesh where n is even and at least 4).
- ``train_once`` / ``RankShare``: one seeded update of the data-parallel
  step, on a rank of a real mesh, or in one process as one rank's share
  (no collectives), whose shares summed are what the collectives give;
- the ranks' workers ``rank_updates`` (steps), ``forward_rows``
  (test-mode forwards, height-sharded on a space axis) and ``rank_runs``
  (several of them in one spawn).

Workers live here, not in test modules: a spawned process imports the
module of the function it runs.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh, close_mesh, make_mesh, rank_device, shard_batch

DRYRUN_HW = (64, 128)
DRYRUN_ITERS = 2


def _rank_entry(rank: int, n: int, init: str, device, backend, out_dir: str,
                fn, args, shape) -> None:
    torch.set_num_threads(1)
    axes = ("data",) if shape is None else ("data", "space")
    mesh = make_mesh(n, axes, shape, device=device, backend=backend,
                     init_method=init, rank=rank)
    try:
        result = fn(mesh, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close_mesh(mesh)


def spawn(fn, n: int, *args, device=None, backend: Optional[str] = None,
          timeout_s: Optional[float] = 1800.0, shape=None) -> list:
    """``fn(mesh, *args)`` on ``n`` spawned ranks; their results in rank
    order. ``device`` / ``backend`` as ``make_mesh`` reads them (None or
    ``"cuda"``: one card per rank, NCCL; ``"cpu"``: gloo; ``"cuda:0"``:
    all ranks on one card, which needs gloo); ``shape`` (D, S): a data x
    space mesh (default: 1-D over ``data``). ``fn`` must be importable by
    name (a module-level function). ``timeout_s`` None: no deadline."""
    rank_device(device)  # raises here, before any rank, without a card
    with tempfile.TemporaryDirectory(prefix="priorflow_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = torch.multiprocessing.start_processes(
            _rank_entry, args=(n, init, device, backend, tmp, fn, args,
                               shape),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{n} ranks of {fn.__name__} ran past "
                                   f"{timeout_s:.0f} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


class RankShare(Mesh):
    """Rank ``rank`` of ``size`` without the others: collectives leave
    their tensors as they are. ``make_train_step(mesh=RankShare(r, n,
    dev))`` on rank r's rows gives rank r's unreduced gradients of the
    global batch's step (its draws included); the shares of all ranks
    summed in one process are what the all-reduce gives."""

    def __init__(self, rank: int, size: int, device):
        super().__init__(None, rank, size, torch.device(device), "none",
                         ("data",), {"data": size})

    def all_reduce_(self, t):
        return t

    def broadcast_(self, t, src: int = 0):
        return t

    def barrier(self) -> None:
        pass

    @property
    def step_space(self):
        # no collectives: the batch statistics stay the rank's
        return None


def synthetic_batch(seed: int, b: int, h: int, w: int):
    """A seeded global batch: images uniform in [0, 255], flow N(0, 3^2)
    per pixel, all valid (``__graft_entry__.py``'s ``SyntheticPairs``
    draws)."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)),
            torch.from_numpy((rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32)),
            torch.ones((b, h, w), dtype=torch.float32))


def train_once(mesh, device, case: dict, batch, steps: int = 1,
               seed: int = 0, **model_kw) -> dict:
    """``steps`` updates of ``make_train_step`` from the model of ``seed``,
    each on ``batch`` (the global batch; a mesh takes its rows), with
    ``clip=inf`` so that ``.grad`` after an update holds the gradients
    before the clip. ``case``: ``grad_mode``, ``noise`` and ``dropout``
    (default standard, off, 0), ``iters``, and ``model``, keywords of
    ``build_model`` beside ``model_kw``. ``mesh`` None: the plain step
    on the whole batch. Returns the first update's metrics, gradients
    (before the clip), parameters and buffers (the batch-statistics
    BatchNorm's running statistics) after it, as CPU tensors, the ms of
    the updates after the first (host clock around a synchronised
    update), the peak device GB, and the kernel launches of the last
    update."""
    from ..models import build_model
    from ..ops.kernels import launch_counts, reset_launch_counts
    from ..train import make_optimizer, make_train_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    model = build_model(dev, seed=seed, dropout=case.get("dropout", 0.0),
                        **model_kw, **case.get("model", {})).train()
    opt, sched = make_optimizer(model.parameters(), 1e-4, 100)
    step = make_train_step(model, opt, sched, iters=case.get("iters", 2),
                           grad_mode=case.get("grad_mode", "standard"),
                           clip=math.inf, noise=case.get("noise", False),
                           seed=seed, mesh=mesh)
    rows = (tuple(t.to(dev) for t in batch) if mesh is None
            else shard_batch(batch, mesh))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out, times = {}, []
    for k in range(steps):
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(rows, k)
        if cuda:
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            out["metrics"] = {n: float(v) for n, v in metrics.items()}
            out["grads"] = {n: p.grad.detach().cpu().clone()
                            for n, p in model.named_parameters()}
            out["params"] = {n: p.detach().cpu().clone()
                             for n, p in model.named_parameters()}
            out["buffers"] = {n: b.detach().cpu().clone()
                              for n, b in model.named_buffers()}
    out["launches"] = {n: c for n, c in launch_counts().items() if c}
    out["ms"] = times[1:]
    out["peak_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                      else None)
    return out


def shares_summed(n: int, device, case: dict, batch, seed: int = 0,
                  **model_kw) -> tuple:
    """In one process: each rank's share of the update's gradients and
    loss (``RankShare``), summed in rank order, the loss in float64 and
    rounded to f32 as ``all_reduce_sums`` sums it. Returns (gradients,
    loss)."""
    total, loss = None, 0.0
    for r in range(n):
        res = train_once(RankShare(r, n, device), device, case, batch,
                         seed=seed, **model_kw)
        g = res["grads"]
        total = g if total is None else {k: total[k] + g[k] for k in total}
        loss += res["metrics"]["train/loss"]
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return total, float(np.float32(loss))


def _same_as_rank0(mesh, tensors: dict) -> bool:
    """Whether every rank's tensors equal rank 0's, bitwise."""
    flat = torch.cat([t.reshape(-1) for t in tensors.values()]).to(
        mesh.device)
    ref = mesh.broadcast_(flat.clone())
    same = torch.tensor([float(torch.equal(flat, ref))], device=mesh.device)
    mesh.all_reduce_(same)
    return bool(same.item() == mesh.size)


def rank_updates(mesh, cases: list, batch, steps: int = 1, seed: int = 0,
                 model_kw: Optional[dict] = None) -> list:
    """A rank's worker for ``spawn``: per case ``train_once`` on this
    rank's rows (``model_kw`` to ``build_model``; a case's ``steps``
    in place of ``steps``); whether every rank's gradients, parameters
    and buffers equal rank 0's bitwise. Rank 0 returns its tensors, the
    others drop them."""
    out = []
    for case in cases:
        res = train_once(mesh, mesh.device, case, batch,
                         case.get("steps", steps), seed, **(model_kw or {}))
        for k in ("grads", "params", "buffers"):
            res[f"{k}_same"] = _same_as_rank0(mesh, res[k])
        if mesh.rank:
            del res["grads"], res["params"], res["buffers"]
        out.append(res)
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def forward_rows(mesh, jobs, seed: int = 0, runs: int = 1,
                 model_kw: Optional[dict] = None, raft: bool = False) -> list:
    """A rank's worker for ``spawn``: the test-mode forward of the model of
    ``seed`` (``model_kw`` to ``build_model``, or with ``raft`` to
    ``build_raft``) on this rank's rows of each global pair of ``jobs``,
    (image1, image2, iters) each, height-sharded over its space group.
    Returns per job the rank's rows of the flow (CPU), the kernel
    launches of one forward, the ms of each of ``runs`` after the first
    (host clock around a synchronised forward), the peak device GB and
    the exchange route."""
    from ..models import build_model, build_raft
    from ..ops.kernels import launch_counts, reset_launch_counts
    from . import spatial

    dev = mesh.device
    cuda = dev.type == "cuda"
    model = (build_raft if raft else build_model)(dev, seed=seed,
                                                  **(model_kw or {}))
    out = []
    for image1, image2, iters in jobs:
        i1, i2 = shard_batch((image1, image2), mesh)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        with spatial.scope(mesh.step_space):
            for k in range(max(runs, 1)):
                reset_launch_counts()
                t0 = time.perf_counter()
                flow = model(i1, i2, iters=iters)
                if cuda:
                    torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
                if k == 0:
                    launches = {n: c for n, c in launch_counts().items()
                                if c}
        out.append(dict(
            flow=flow.cpu(), launches=launches, ms=times[1:],
            peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9 if cuda
                     else None),
            route=None if mesh.space is None else mesh.space.route))
        del flow
        if cuda:
            torch.cuda.empty_cache()
    return out


def rank_runs(mesh, runs: list) -> list:
    """A rank's worker for ``spawn``: several of the workers above in one
    process, in order; ``runs`` lists ("forward_rows" or "rank_updates",
    the arguments after ``mesh``)."""
    workers = {"forward_rows": forward_rows, "rank_updates": rank_updates}
    return [workers[name](mesh, *args) for name, args in runs]


class SyntheticPairs:
    """Tiny in-memory dataset with the FlowDataset sample contract
    (``__graft_entry__.py:75-94``)."""

    def __init__(self, n: int = 4, h: int = DRYRUN_HW[0],
                 w: int = DRYRUN_HW[1]):
        rng = np.random.default_rng(0)
        self.items = [
            (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
             rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
             (rng.normal(size=(h, w, 2)) * 3).astype(np.float32),
             np.ones((h, w), np.float32))
            for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


def _dryrun_rank(mesh, save_path: str, batch: int) -> dict:
    from ..data.loader import DataLoader
    from ..train.trainer import Trainer, TrainerConfig

    seen = {}
    cfg = TrainerConfig(num_steps=1, batch_size=batch, iters=DRYRUN_ITERS,
                        save_path=save_path, val_freq=10 ** 9)
    trainer = Trainer(cfg, mesh=mesh,
                      logger=lambda metrics, step: seen.update(metrics))
    loader = DataLoader(SyntheticPairs(2 * batch), batch_size=batch,
                        shuffle=False, num_workers=0)
    trainer.run(loader)
    return {"step": trainer.step, "mesh": dict(mesh.shape),
            "loss": seen.get("train/loss", math.nan),
            "epe": seen.get("A-epe", math.nan),
            "logged": bool(seen)}


def dryrun_multichip(n_devices: int, device=None,
                     backend: Optional[str] = None) -> dict:
    """``Trainer.run`` for 2 updates (``num_steps=1``) on ``n_devices``
    spawned ranks, on ``SyntheticPairs`` at 64x128, 2 GRU iterations, as
    JAX's (``__graft_entry__.py:61-71``): a 2 x (n/2) data x space mesh
    and a global batch of 2 where n is even and at least 4, else a 1-D
    mesh and a global batch of n. Raises unless rank 0's loss is finite,
    only rank 0 logged and every rank took 2 updates, then prints JAX's
    line. ``device`` / ``backend`` as ``spawn`` reads them (one card per
    rank by default; ``device="cpu"`` for gloo ranks on the CPU).
    Returns rank 0's result."""
    if n_devices % 2 == 0 and n_devices >= 4:
        shape, batch = (2, n_devices // 2), 2
    else:
        shape, batch = None, n_devices
    with tempfile.TemporaryDirectory(prefix="priorflow_dryrun_") as tmp:
        results = spawn(_dryrun_rank, n_devices, tmp, batch, device=device,
                        backend=backend, shape=shape)
        wrote = sorted(os.listdir(tmp))
    r0 = results[0]
    loss = r0["loss"]
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}): bad loss {loss}")
    if [r["step"] for r in results] != [2] * n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): expected 2 "
                           f"steps on every rank, got "
                           f"{[r['step'] for r in results]}")
    if [r["logged"] for r in results] != [True] + [False] * (n_devices - 1):
        raise RuntimeError(f"dryrun_multichip({n_devices}): only rank 0 "
                           f"logs")
    if wrote != ["final"]:
        raise RuntimeError(f"dryrun_multichip({n_devices}): wrote {wrote}")
    print(f"dryrun_multichip({n_devices}): ok, mesh={r0['mesh']}, "
          f"Trainer.run 2 steps, loss={loss:.4f}, epe={r0['epe']:.3f}",
          flush=True)
    return r0
