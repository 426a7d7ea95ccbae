"""One training step in two gradient modes, and the training loop
(counterpart of ``prior_flow_tpu/train/trainer.py``).

- ``make_train_step``: B-branch ground truth from ``flo_a2b`` per batch
  element without grad, the dual-branch sequence loss, the global-norm clip
  and the AdamW step (``trainer.py:197-268``).
- ``grad_mode='standard'``: ``loss.backward()`` through the training
  forward; every iteration's lookup backward scatters into the pyramid
  (``ops/corr.py::DCCLAllLevelsLookup``).
- ``grad_mode='taped'``: ``taped_value_and_grad``, one forward whose
  lookups are primal-only, then ONE stacked scatter per level and volume
  over all iterations (``trainer.py:68-194``). The lookup is linear in the
  volume and the coords are detached every iteration, so both modes give
  the same gradients.
- A model built with ``deferred_vol_grad=True`` takes, in the standard
  mode, the two-pass training forward of ``models/prior_raft.py`` (a
  no-grad recording pass, the rebind, the replay); its backward runs the
  taped mode's stacked scatter, which both share:
  ``ops.corr.stacked_volume_cotangents``. The taped mode ignores the
  field, as JAX's ``iterate_taped`` does.
- ``add_noise``: gaussian noise of a per-step standard deviation on both
  images (``trainer.py:230-237``), drawn from a generator keyed by
  (seed, step), as the encoders' dropout draws are: a resumed run draws
  what an uninterrupted one would.
- ``mesh`` (``parallel.make_mesh``): the data-parallel step and loop,
  one process per device, the gradients summed over the ranks before the
  clip (``trainer.py:299-305,369-392,414-420``); on a data x space mesh
  (``parallel.make_mesh_2d``) each rank also takes its height rows and
  the step runs height-sharded (``parallel/spatial.py``).
- ``Trainer``: the loop of ``trainer.py:398-460``: ``num_steps + 1``
  updates; every 100 steps the metrics with ``train/steps_per_sec`` and
  ``train/learning_rate``; image panels every ``IMAGE_LOG_FREQ``; a
  checkpoint and the validators every ``val_freq`` steps; ``final`` at
  the end. A checkpoint is a directory: ``model.pth`` in the reference
  layout and ``train_state.pt`` (optimizer moments and step). Restore
  takes such a directory (the whole state; the schedule position is the
  step), a reference ``.pth`` (loaded strictly, else the FlyingThings
  graft), or ``"auto"``, the newest checkpoint under ``save_path``.

bf16 autocast needs no loss scaling (bf16 has f32's exponent range), as in
the JAX package. Rematerialisation is the model's (``PriOrRAFT(remat,
remat_policy)``; ``TrainerConfig.remat_policy``, where ``"none"`` turns it
off): both grad modes recompute each GRU iteration's update in the
backward, never its lookup.
The taped mode needs the volume route (``corr_mode="volume"``). Not
ported: the Orbax checkpoints of the JAX package (ROADMAP).
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint.convert import (ORBAX_HINT, convert_things_ckpt, load_pth,
                                  write_pth)
from ..data.loader import device_prefetch
from ..models import build_model, precision_scope
from ..nn.layers import RankDraws, draw_rows
from ..ops.corr import DCCLFused, stacked_volume_cotangents
from ..ops.warp import flo_a2b
from ..parallel import spatial
from ..parallel.mesh import (all_reduce_grads, all_reduce_sums,
                             height_sharding, replicated,
                             spatial_batch_sharding)
from .loss import metric_ratios, sequence_loss_sums
from .optim import clip_by_global_norm_, global_norm, make_optimizer

VAL_FREQ = 5000
IMAGE_LOG_FREQ = 1024
LOG_FREQ = 100
CLOCK_STEPS = 1000        # the steps ``LoopClock`` keeps
MODEL_FILE, STATE_FILE = "model.pth", "train_state.pt"
# the per-step random streams
NOISE, DROPOUT = 0, 1


def step_generator(seed: int, step: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` keyed by (seed, step, stream) alone."""
    state = np.random.SeedSequence([seed, step, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def draw_noise(image: torch.Tensor, generator):
    """One step's noise draws: stdv ~ U(0, 5), and N(0, 1) per element of
    each image of the pair. With a ``RankDraws`` (a data-parallel step)
    the per-element draws are the global batch's, of which this rank's
    rows are kept."""
    g = generator.generator if isinstance(generator, RankDraws) else generator
    stdv = torch.rand((), generator=g, device=image.device) * 5.0
    return stdv, *(draw_rows(torch.randn, image.shape, generator,
                             image.device, hdim=1) for _ in range(2))


def add_noise(image1, image2, stdv, noise1, noise2):
    """Both images plus ``stdv`` times their noise, clipped to [0, 255]
    (``prior_flow_tpu/train/trainer.py:230-237``)."""
    return ((image1 + stdv * noise1).clamp(0.0, 255.0),
            (image2 + stdv * noise2).clamp(0.0, 255.0))


def dual_loss(preds_A, preds_B, flow_gt, valid, flow_gt_B, valid_B,
              gamma: float, mesh=None):
    """loss A + loss B and both branches' metrics (``trainer.py:156-161``).
    With a ``mesh`` the metrics are the global batch's: their numerators
    and valid counts are summed over the ranks first. The loss stays this
    rank's (its backward gives this rank's share of the gradients)."""
    loss_A, s_A = sequence_loss_sums(preds_A, flow_gt, valid, gamma=gamma)
    loss_B, s_B = sequence_loss_sums(preds_B, flow_gt_B, valid_B,
                                     gamma=gamma)
    if mesh is not None:
        keys = list(s_A)
        sums = all_reduce_sums([s_A[k] for k in keys]
                               + [s_B[k] for k in keys], mesh)
        s_A, s_B = dict(zip(keys, sums)), dict(zip(keys, sums[len(keys):]))
    return loss_A + loss_B, {**metric_ratios(s_A, "A-"),
                             **metric_ratios(s_B, "B-")}


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


def taped_value_and_grad(model, image1, image2, flow_gt, valid, flow_gt_B,
                         valid_B, iters: int, gamma: float, generator=None,
                         mesh=None):
    """Loss and gradients by the single-forward taped path; the gradients
    are ACCUMULATED into the parameters' ``.grad``. Returns
    (loss, metrics).

    (a) encode with graph, outputs detached into leaves; (b) the pyramids
    from the fmap leaves, with graph; (c) the GRU loop with record lookups
    on the detached pyramids, each iteration's summed field a leaf, and
    ``backward`` of the loss; (d) the stacked field cotangents into the
    volume cotangents by ``ops.corr.stacked_volume_cotangents`` (the
    transposed back-rotation of their cross part, then per level and
    volume ONE grid-entry scatter with S = iters; shared with
    ``PriOrRAFT(deferred_vol_grad=True)``'s rebind); (e) backward through
    the pyramid build, then through the encoder with the leaves'
    gradients.
    ``generator``: the encoders' dropout draws; ``mesh``: as ``dual_loss``
    reads it. Refuses ``corr_mode="onthefly"``
    (``prior_flow_tpu/train/trainer.py:102-103``): the stacked scatter
    needs volumes; and the ``mxu`` / ``gather`` lookups, which have no
    ``DCCLFused.record`` (the JAX CLI pins ``pallas`` for the taped mode,
    ``prior_flow_tpu/cli/train.py:116-121``).

    Height-sharded (a ``spatial.scope``: the images hold the rank's real
    rows, padded here to its strip, and the flows are cut back to them
    before the loss), each fmap2 is gathered in (a)'s graph and the
    whole image's becomes the leaf, so (b) and (c) read it as the
    sharded forward does, and (e) reduce-scatters its cotangent back
    through the gather into the encoder. The recorded centres are global
    pixels of the rank's queries; (d)'s transposed back-rotation is the
    transpose of the sharded ``resample_static``
    (``resample_static_transpose`` at the rank's strip) and its scatters
    write the rank's rows of each volume.
    Every rank issues the same collectives in the same order: each stage
    runs on every rank, and each backward walks the same graph.
    """
    if model.corr_mode == "onthefly":
        raise ValueError("taped gradients require corr_mode='volume'")
    if not isinstance(model.dccl, DCCLFused):
        raise ValueError(f"taped gradients require the kernel lookup "
                         f"(lookup_mode 'auto' or 'pallas'), not "
                         f"{model.lookup_mode!r}")
    B, H, W, _ = image1.shape
    space = spatial.current()
    if space is not None:   # the rank's real rows -> its strip
        space = spatial.enter(H, image1.device)
        H = space.height
        image1, image2 = space.pad(image1, 1), space.pad(image2, 1)
    g = model.rotation_grids(H, W, image1.device)
    enc = model.encode(image1, image2, g,
                       model.dropout_generator(generator))       # (a)
    outs = (*enc[:4], *enc[4])
    if space is not None:   # the targets: fmap2 of the whole image
        outs = (*outs[:5], spatial.gather_rows(outs[5], 1, space), outs[6],
                spatial.gather_rows(outs[7], 1, space))
    leaves = tuple(_leaf(t) for t in outs)
    net_A, net_B, inp_A, inp_B = leaves[:4]
    fmaps = leaves[4:]
    pyr_A, pyr_B = model.build_pyramids(fmaps)                    # (b)

    (preds_A, preds_B), (fields_A, fields_B), (cen_A, cen_B) = \
        model.iterate_taped(net_A, net_B, inp_A, inp_B, fmaps[0], fmaps[1],
                            pyr_A, pyr_B, iters)                  # (c)
    if space is not None:   # the rank's real rows of the flows
        preds_A, preds_B = space.crop(preds_A, 2), space.crop(preds_B, 2)
    loss, metrics = dual_loss(preds_A, preds_B, flow_gt, valid, flow_gt_B,
                              valid_B, gamma, mesh)
    loss.backward()

    with torch.no_grad():                                         # (d)
        d_pyr = stacked_volume_cotangents(
            torch.stack([f.grad for f in fields_A]),
            torch.stack([f.grad for f in fields_B]), cen_A, cen_B,
            [(v.shape[2], v.shape[3], v.dtype) for v in pyr_A], g)

    torch.autograd.backward([*pyr_A, *pyr_B],                     # (e)
                            [d[0] for d in d_pyr] + [d[1] for d in d_pyr])
    pairs = [(o, l.grad) for o, l in zip(outs, leaves) if l.grad is not None]
    torch.autograd.backward([o for o, _ in pairs], [d for _, d in pairs])
    return loss.detach(), metrics


def make_train_step(model, optimizer, schedule: Callable[[int], float],
                    iters: int = 12, gamma: float = 0.8,
                    grad_mode: str = "standard", clip: float = 1.0,
                    noise: bool = False, seed: int = 0, mesh=None):
    """step(batch, step_index) -> metrics; updates ``model`` and
    ``optimizer`` in place. batch = (image1, image2, flow_gt, valid),
    channels-last f32 on the model's device. Update k runs at
    ``schedule(k)``; with ``noise`` its images get ``add_noise``. The
    noise and the dropout draws come from generators keyed by (``seed``,
    k). Metrics are 0-dim tensors,
    ``train/loss`` and ``train/grad_norm`` (before the clip) among them.
    The forward and the backward run at ``model.precision``
    (``trainer.py:125-126``).

    With a ``mesh`` (``parallel.make_mesh``) the step is one rank's share
    of the step on the global batch, as JAX's SPMD step is
    (``trainer.py:369-392``): ``batch`` holds this rank's rows, the noise
    and dropout draws are the global batch's rows of this rank
    (``nn.layers.RankDraws``), the gradients are summed over the ranks in
    one flat bucket after the backward and before the norm and the clip,
    and ``train/loss`` and the metrics are the global batch's. Every rank
    then takes the same update. A clip of ``inf`` leaves ``.grad`` as the
    gradients before the clip. On a mesh with a space axis (S > 1) the
    batch holds this rank's real height rows too (any height JAX shards,
    ``parallel.height_sharding``), and the step (the B ground truth, the
    draws, the forward, the loss and the backward, in either grad mode)
    runs height-sharded over the rank's space group; the sums stay over
    all ranks. On a data-only mesh of several ranks the step runs in a
    scope of one height slice (``Mesh.step_space``): nothing is sharded,
    but a batch-statistics BatchNorm normalises by the global batch's
    statistics, as JAX's jitted step on a ``P('data')`` batch does."""
    if grad_mode not in ("standard", "taped"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    space = None if mesh is None else mesh.step_space
    params = [p for p in model.parameters() if p.requires_grad]

    def draws(generator):
        return (generator if mesh is None else RankDraws(
            generator, mesh.data_rank, mesh.data_size, mesh.space_rank,
            mesh.space_size))

    def train_step(batch, step: int) -> Dict[str, torch.Tensor]:
        with spatial.scope(space):
            return sharded_step(batch, step)

    def sharded_step(batch, step: int) -> Dict[str, torch.Tensor]:
        image1, image2, flow_gt, valid = batch
        dev = flow_gt.device
        H = flow_gt.shape[1]
        # the rank's real rows <-> its strip (the identity unsharded)
        pad = crop = lambda t: t
        sp = spatial.current()
        if sp is not None:
            sp = spatial.enter(H, dev)
            H = sp.height
            pad, crop = (lambda t: sp.pad(t, 1)), (lambda t: sp.crop(t, 1))
        g = model.rotation_grids(H, flow_gt.shape[2], dev)
        with torch.no_grad():
            strips = pad(flow_gt)
            flow_gt_B = crop(torch.cat([flo_a2b(strips[i:i + 1], g)
                                        for i in range(flow_gt.shape[0])]))
            valid_B = ((flow_gt_B[..., 0].abs() < 1000)
                       & (flow_gt_B[..., 1].abs() < 1000)).float()
            if noise:
                stdv, noise1, noise2 = draw_noise(
                    pad(image1), draws(step_generator(seed, step, NOISE,
                                                      dev)))
                image1, image2 = add_noise(image1, image2, stdv,
                                           crop(noise1), crop(noise2))
        gen = (draws(step_generator(seed, step, DROPOUT, dev))
               if model.dropout > 0 else None)
        optimizer.zero_grad(set_to_none=True)
        with precision_scope(model.precision):
            if grad_mode == "taped":
                loss, metrics = taped_value_and_grad(
                    model, image1, image2, flow_gt, valid, flow_gt_B,
                    valid_B, iters, gamma, generator=gen, mesh=mesh)
            else:
                preds_A, preds_B = model(image1, image2, iters=iters,
                                         test_mode=False, generator=gen)
                loss, metrics = dual_loss(preds_A, preds_B, flow_gt, valid,
                                          flow_gt_B, valid_B, gamma, mesh)
                loss.backward()
                loss = loss.detach()
        for p in params:           # optax updates every parameter
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if mesh is not None:
            all_reduce_grads(grads, mesh)
            (loss,) = all_reduce_sums([loss], mesh)
        norm = global_norm(grads)
        clip_by_global_norm_(grads, norm, clip)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        optimizer.step()
        return {**metrics, "train/loss": loss, "train/grad_norm": norm}

    return train_step


def remat_options(policy: str) -> dict:
    """``PriOrRAFT``'s ``remat`` / ``remat_policy`` for a
    ``TrainerConfig.remat_policy``."""
    if policy == "none":
        return dict(remat=False)
    return dict(remat=True, remat_policy=policy)


@dataclass
class TrainerConfig:
    """The flags of ``prior_flow_tpu/train/trainer.py::TrainerConfig``
    (EFT recipe defaults), and ``remat_policy``, which the JAX CLI gives
    its model (``prior_flow_tpu/cli/train.py:121-124``): a policy of
    ``PriOrRAFT``, or ``"none"`` for no rematerialisation (``remat=False``;
    at the EFT recipe the step then fits the card and runs fastest)."""

    name: str = "EFT"
    stage: str = "EFT"
    lr: float = 1e-4
    num_steps: int = 60000
    batch_size: int = 4
    iters: int = 12
    wdecay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8
    add_noise: bool = False
    grad_mode: str = "standard"
    mixed_precision: bool = False
    dropout: float = 0.0
    save_path: str = "./checkpoints"
    restore_ckpt: Optional[str] = None
    validation: tuple = ()
    val_freq: int = VAL_FREQ
    seed: int = 1234
    data_root: Optional[str] = None
    remat_policy: str = "dccl"


class Trainer:
    """Model, optimizer and step counter; ``run`` trains over a loader.

    Weights come from ``state_dict`` (reference layout, strict) or from
    the seeded init, then from ``cfg.restore_ckpt`` where given; the model
    lives on ``device`` (default: the card). ``logger(metrics, step)``
    gets host floats (and ``log_images(panels, step)`` where it has one);
    ``validators`` maps a name of ``cfg.validation`` to a function of the
    model that returns metrics.

    With a ``mesh`` (``parallel.make_mesh``; JAX's ``Trainer(mesh=)``,
    ``trainer.py:299-305,414-420``) every rank builds and restores the
    model on ``mesh.device``, then takes rank 0's weights
    (``parallel.replicated``); each step is the data-parallel step of
    ``make_train_step(mesh=)`` on this rank's rows of each global batch
    of ``cfg.batch_size``. Only rank 0 logs, draws panels, writes
    checkpoints and validates; every rank waits for each checkpoint, so a
    ``restore("auto")`` on any rank finds it."""

    def __init__(self, cfg: TrainerConfig, device=None, state_dict=None,
                 logger: Optional[Callable[[Dict, int], None]] = None,
                 validators: Optional[Dict[str, Callable]] = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            d = torch.device(device if device is not None else
                             mesh.device)
            if d.type != mesh.device.type or \
                    d.index not in (None, mesh.device.index):
                raise ValueError(f"device {device} is not the mesh rank's "
                                 f"{mesh.device}")
            device = mesh.device
        self.model = build_model(device, seed=cfg.seed, state_dict=state_dict,
                                 mixed_precision=cfg.mixed_precision,
                                 dropout=cfg.dropout,
                                 **remat_options(cfg.remat_policy)).train()
        self.optimizer, self.schedule = make_optimizer(
            self.model.parameters(), cfg.lr, cfg.num_steps, cfg.wdecay,
            cfg.epsilon)
        self.step = 0
        self.logger = logger or (lambda metrics, step: None)
        self.validators = validators or {}
        self.clock = LoopClock(self.device)
        if cfg.restore_ckpt:
            self.restore(cfg.restore_ckpt)
        elif mesh is not None:
            replicated(mesh, self.model)
        self._step_fn = make_train_step(
            self.model, self.optimizer, self.schedule, cfg.iters, cfg.gamma,
            cfg.grad_mode, cfg.clip, noise=cfg.add_noise, seed=cfg.seed,
            mesh=mesh)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def is_main(self) -> bool:
        """True where this process logs and writes: without a mesh, or on
        rank 0."""
        return self.mesh is None or self.mesh.rank == 0

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One update on ``batch`` (with a mesh: this rank's rows)."""
        dev = self.device
        metrics = self._step_fn(tuple(t.to(dev) for t in batch), self.step)
        self.step += 1
        return metrics

    def run(self, loader) -> Dict[str, torch.Tensor]:
        """Train from ``self.step`` to ``cfg.num_steps`` inclusive
        (``num_steps + 1`` updates in a fresh run, as in the JAX package),
        then save ``final``. ``loader``: a ``data.DataLoader`` (its
        infinite stream, resumed at ``self.step``) or any iterable of
        (image1, image2, flow_gt, valid, ...) batches, which ends the run
        early when it runs out. Batch k+1 is copied to the device while
        step k runs. With a mesh each rank reads only its rows of each
        global batch: a ``DataLoader`` decodes only this rank's samples,
        and of another iterable's batches the rank keeps its rows. Returns
        the last step's metrics."""
        cfg = self.cfg
        total = self.step
        mesh = self.mesh
        if hasattr(loader, "infinite"):
            rows = {} if mesh is None else dict(rank=mesh.data_rank,
                                                world=mesh.data_size)
            source = loader.infinite(start_batch=total, **rows)
            shard = (lambda x: x) if mesh is None else height_sharding(mesh)
        else:
            source = iter(loader)
            shard = ((lambda x: x) if mesh is None
                     else spatial_batch_sharding(mesh))
        batches = (tuple(shard(x) for x in b[:4]) for b in source)
        it = device_prefetch(batches, self.device)
        clock = self.clock = LoopClock(self.device)
        metrics = {}
        try:
            batch = clock.wait(it)
            t_last = time.perf_counter()
            while batch is not None and total <= cfg.num_steps:
                with clock.step():
                    metrics = self.train_step(batch)
                if total % LOG_FREQ == 0 and self.is_main:
                    host = {k: float(v) for k, v in metrics.items()}
                    t_now = time.perf_counter()
                    host["train/steps_per_sec"] = LOG_FREQ / max(
                        t_now - t_last, 1e-9)
                    host["train/learning_rate"] = float(self.schedule(total))
                    t_last = t_now
                    self.logger(host, total)
                if total % IMAGE_LOG_FREQ == 0:
                    self._log_image_panels(batch, total)
                if total % cfg.val_freq == cfg.val_freq - 1:
                    self.save(total + 1)
                    results = self.validate() if self.is_main else {}
                    if results:
                        self.logger(results, total)
                total += 1
                if total > cfg.num_steps:
                    break
                batch = clock.wait(it)
        finally:
            it.close()
            if hasattr(source, "close"):
                source.close()
        self.save("final")
        return metrics

    def validate(self) -> Dict[str, float]:
        """The validators named in ``cfg.validation``, in eval mode under
        no_grad; the model returns to train mode after them."""
        results = {}
        todo = [(n, v) for n, v in self.validators.items()
                if n in self.cfg.validation]
        if not todo:
            return results
        self.model.eval()
        try:
            with torch.no_grad():
                for _, validator in todo:
                    results.update(validator(self.model))
        finally:
            self.model.train()
        return results

    def _log_image_panels(self, batch, step: int):
        """Input, orthogonal view, ground truth and both branches' last
        predictions of the batch's first pair as colour panels
        (``trainer.py:463-490``), drawn by the main rank where its logger
        draws images. On a mesh with a space axis every rank first gathers
        its group's rows of that pair, and the panels' forward runs on
        the whole images, unsharded."""
        from ..ops.warp import img_a2b
        from ..utils.flow_viz import omniflow_to_image

        image1, image2, flow_gt = batch[0][:1], batch[1][:1], batch[2][:1]
        space = None if self.mesh is None else self.mesh.space
        if space is not None:
            space = spatial.geometry(space, image1.shape[1], image1.device)
            image1, image2, flow_gt = (
                spatial.gather_rows(space.pad(t, 1), 1, space)
                for t in (image1, image2, flow_gt))
        if not (self.is_main and hasattr(self.logger, "log_images")):
            return
        self.model.eval()
        try:
            with torch.no_grad():
                preds_A, preds_B = self.model(image1, image2,
                                              iters=self.cfg.iters,
                                              test_mode=False)
                image1_B = img_a2b(image1)
        finally:
            self.model.train()
        host = lambda t: t[0].float().cpu().numpy()
        panels = {
            "image1": host(image1),
            "image2": host(image2),
            "image1_B": host(image1_B),
            "flow_gt": omniflow_to_image(host(flow_gt)),
            "flow_pred_A": omniflow_to_image(host(preds_A[-1])),
            "flow_pred_B": omniflow_to_image(host(preds_B[-1])),
        }
        self.logger.log_images(panels, step)

    def save(self, tag) -> str:
        """The checkpoint ``<save_path>/<tag>/``: ``model.pth`` in the
        reference layout (``cli.evaluate --model`` takes it) and
        ``train_state.pt`` with the optimizer state and the step. With a
        mesh every rank calls it, rank 0 writes, and all return once the
        files are written."""
        path = os.path.join(os.path.abspath(self.cfg.save_path), str(tag))
        if self.is_main:
            os.makedirs(path, exist_ok=True)
            write_pth(self.model.state_dict(), os.path.join(path, MODEL_FILE))
            torch.save({"optimizer": self.optimizer.state_dict(),
                        "step": self.step}, os.path.join(path, STATE_FILE))
        if self.mesh is not None:
            self.mesh.barrier()
        return path

    def latest_checkpoint(self) -> Optional[str]:
        """``final`` under ``save_path`` if it exists, else its highest
        numbered step, else None (``trainer.py:335-347``)."""
        root = os.path.abspath(self.cfg.save_path)
        if not os.path.isdir(root):
            return None
        if os.path.isdir(os.path.join(root, "final")):
            return os.path.join(root, "final")
        steps = [d for d in os.listdir(root) if d.isdigit()]
        return os.path.join(root, max(steps, key=int)) if steps else None

    def restore(self, path: str) -> None:
        """Restore from ``path`` (``trainer.py:313-367``): a checkpoint
        directory of ``save`` gives the model, the optimizer state and the
        step; a reference ``.pth`` (with or without the ``module.`` prefix)
        loads strictly where its names and shapes are the model's, and
        through the FlyingThings graft where they are not; ``"auto"`` takes
        ``latest_checkpoint()`` (nothing when there is none). With a mesh
        every rank restores, then takes rank 0's weights."""
        self._restore(path)
        if self.mesh is not None:
            replicated(self.mesh, self.model)

    def _restore(self, path: str) -> None:
        if path == "auto":
            path = self.latest_checkpoint()
            if path is None:
                return
        if os.path.isdir(path):
            state = os.path.join(path, STATE_FILE)
            if not os.path.exists(state):
                raise ValueError(
                    f"{path} is a directory without {STATE_FILE} (an Orbax "
                    f"checkpoint of the JAX package?): the port restores "
                    f"its own checkpoints and .pth files; {ORBAX_HINT}")
            self.model.load_state_dict(
                load_pth(os.path.join(path, MODEL_FILE)), strict=True)
            st = torch.load(state, map_location=self.device,
                            weights_only=True)
            self.optimizer.load_state_dict(st["optimizer"])
            self.step = int(st["step"])
            return
        sd = load_pth(path)
        own = self.model.state_dict()
        exact = sd.keys() == own.keys() and all(
            tuple(sd[k].shape) == tuple(v.shape) for k, v in own.items())
        self.model.load_state_dict(
            sd if exact else convert_things_ckpt(sd, own), strict=True)


class LoopClock:
    """Per step of ``Trainer.run`` (the last ``CLOCK_STEPS``): the host
    seconds spent waiting on the loader for its batch, and the step's
    time. On a card each step is
    bracketed by two CUDA events on the compute stream, read only at the
    end (no synchronisation inside the loop): ``step_ms`` is the card's
    time from the step's first to its last kernel, ``gap_ms`` the card's
    time between one step's end and the next one's start. On the CPU
    both are host times."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.wait_s = collections.deque(maxlen=CLOCK_STEPS)
        self._marks = collections.deque(maxlen=CLOCK_STEPS)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def wait(self, it):
        """``next(it)``, None at its end, timed."""
        t0 = time.perf_counter()
        item = next(it, None)
        self.wait_s.append(time.perf_counter() - t0)
        return item

    @contextlib.contextmanager
    def step(self):
        start = self._mark()
        yield
        self._marks.append((start, self._mark()))

    def _elapsed_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def step_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
        return [self._elapsed_ms(a, b) for a, b in self._marks]

    def gap_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
        marks = list(self._marks)
        return [self._elapsed_ms(a[1], b[0])
                for a, b in zip(marks, marks[1:])]
