"""One training step in two gradient modes, and a small training loop
(counterpart of ``prior_flow_tpu/train/trainer.py``).

- ``make_train_step``: B-branch ground truth from ``flo_a2b`` per batch
  element without grad, the dual-branch sequence loss, the global-norm clip
  and the AdamW step (``trainer.py:197-268``).
- ``grad_mode='standard'``: ``loss.backward()`` through the training
  forward; every iteration's lookup backward scatters into the pyramid
  (``ops/corr.py::DCCLLevelLookup``).
- ``grad_mode='taped'``: ``taped_value_and_grad``, one forward whose
  lookups are primal-only, then ONE stacked scatter per level and volume
  over all iterations (``trainer.py:68-194``). The lookup is linear in the
  volume and the coords are detached every iteration, so both modes give
  the same gradients.
- ``Trainer``: seeded or given weights, ``run`` over any iterable of
  batches, ``save`` / ``load`` of {model, optimizer, step}.

bf16 autocast needs no loss scaling (bf16 has f32's exponent range), as in
the JAX package. Not ported: Orbax or ``.pth`` restore into training,
validators, the logger and image panels, ``add_noise``, dropout,
rematerialisation and the data loaders (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import torch

from ..models import build_model
from ..ops.kernels.dccl_coords import dccl_grid_coords
from ..ops.kernels.dccl_scatter import dccl_level_scatter
from ..ops.static_resample import resample_static_transpose
from ..ops.warp import flo_a2b
from .loss import uniform_sequence_loss
from .optim import clip_by_global_norm_, global_norm, make_optimizer


def dual_loss(preds_A, preds_B, flow_gt, valid, flow_gt_B, valid_B,
              gamma: float):
    """loss A + loss B and both branches' metrics (``trainer.py:156-161``)."""
    loss_A, m_A = uniform_sequence_loss(preds_A, flow_gt, valid, gamma=gamma,
                                        prefix="A-")
    loss_B, m_B = uniform_sequence_loss(preds_B, flow_gt_B, valid_B,
                                        gamma=gamma, prefix="B-")
    return loss_A + loss_B, {**m_A, **m_B}


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_()


def taped_value_and_grad(model, image1, image2, flow_gt, valid, flow_gt_B,
                         valid_B, iters: int, gamma: float):
    """Loss and gradients by the single-forward taped path; the gradients
    are ACCUMULATED into the parameters' ``.grad``. Returns
    (loss, metrics).

    (a) encode with graph, outputs detached into leaves; (b) the pyramids
    from the fmap leaves, with graph; (c) the GRU loop with record lookups
    on the detached pyramids, each iteration's summed field a leaf, and
    ``backward`` of the loss; (d) the stacked field cotangents, the
    transposed back-rotation for their cross part, then per level and branch
    ONE coords launch and per level and volume ONE scatter with S = iters
    (``dccl_gather.py::_rebind_bwd``); (e) backward through the pyramid
    build, then through the encoder with the leaves' gradients.
    """
    B, H, W, _ = image1.shape
    g = model.rotation_grids(H, W, image1.device)
    enc = model.encode(image1, image2, g)                         # (a)
    net_A, net_B, inp_A, inp_B = (_leaf(t) for t in enc[:4])
    fmaps = tuple(_leaf(f) for f in enc[4])
    pyr_A, pyr_B = model.build_pyramids(fmaps)                    # (b)

    (preds_A, preds_B), (fields_A, fields_B), (cen_A, cen_B) = \
        model.iterate_taped(net_A, net_B, inp_A, inp_B, fmaps[0], fmaps[1],
                            pyr_A, pyr_B, iters)                  # (c)
    loss, metrics = dual_loss(preds_A, preds_B, flow_gt, valid, flow_gt_B,
                              valid_B, gamma)
    loss.backward()

    with torch.no_grad():                                         # (d)
        gA = torch.stack([f.grad for f in fields_A])   # (S, B, h1, w1, L*81)
        gB = torch.stack([f.grad for f in fields_B])
        S, _, h1, w1, C = gA.shape
        Q = h1 * w1

        def back_rot_t(gf, grid):
            # own and cross were summed, so both read the field cotangent
            ct = resample_static_transpose(gf.reshape(S * B, h1, w1, C),
                                           grid, (h1, w1))
            return ct.reshape(S, B, Q, C)

        gA_cross = back_rot_t(gA, g.b2a_8)
        gB_cross = back_rot_t(gB, g.a2b_8)
        gA_own = gA.reshape(S, B, Q, C)
        gB_own = gB.reshape(S, B, Q, C)
        d_pyr = []
        for lvl, (vA, vB) in enumerate(zip(pyr_A, pyr_B)):
            s = 1.0 / 2.0 ** lvl
            sl = slice(lvl * 81, (lvl + 1) * 81)
            cxA, cyA = (c.reshape(S, B, Q, 81) for c in dccl_grid_coords(
                cen_A.reshape(-1, 2), g.a2b_w2c_8, s))
            cxB, cyB = (c.reshape(S, B, Q, 81) for c in dccl_grid_coords(
                cen_B.reshape(-1, 2), g.b2a_w2c_8, s))
            Hl, Wl = vA.shape[2:]
            part = lambda t: t[..., sl].contiguous()
            d_pyr.append((
                dccl_level_scatter(part(gA_own), cen_A, s, part(gB_cross),
                                   cxB, cyB, Hl, Wl, vA.dtype),
                dccl_level_scatter(part(gB_own), cen_B, s, part(gA_cross),
                                   cxA, cyA, Hl, Wl, vB.dtype)))

    torch.autograd.backward([*pyr_A, *pyr_B],                     # (e)
                            [d[0] for d in d_pyr] + [d[1] for d in d_pyr])
    leaves = (net_A, net_B, inp_A, inp_B, *fmaps)
    outs = (*enc[:4], *enc[4])
    pairs = [(o, l.grad) for o, l in zip(outs, leaves) if l.grad is not None]
    torch.autograd.backward([o for o, _ in pairs], [d for _, d in pairs])
    return loss.detach(), metrics


def make_train_step(model, optimizer, schedule: Callable[[int], float],
                    iters: int = 12, gamma: float = 0.8,
                    grad_mode: str = "standard", clip: float = 1.0):
    """step(batch, step_index) -> metrics; updates ``model`` and
    ``optimizer`` in place. batch = (image1, image2, flow_gt, valid),
    channels-last f32 on the model's device. Update k runs at
    ``schedule(k)``. Metrics are 0-dim tensors, ``train/loss`` and
    ``train/grad_norm`` (before the clip) among them."""
    if grad_mode not in ("standard", "taped"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch, step: int) -> Dict[str, torch.Tensor]:
        image1, image2, flow_gt, valid = batch
        g = model.rotation_grids(flow_gt.shape[1], flow_gt.shape[2],
                                 flow_gt.device)
        with torch.no_grad():
            flow_gt_B = torch.cat([flo_a2b(flow_gt[i:i + 1], g)
                                   for i in range(flow_gt.shape[0])])
            valid_B = ((flow_gt_B[..., 0].abs() < 1000)
                       & (flow_gt_B[..., 1].abs() < 1000)).float()
        optimizer.zero_grad(set_to_none=True)
        if grad_mode == "taped":
            loss, metrics = taped_value_and_grad(
                model, image1, image2, flow_gt, valid, flow_gt_B, valid_B,
                iters, gamma)
        else:
            preds_A, preds_B = model(image1, image2, iters=iters,
                                     test_mode=False)
            loss, metrics = dual_loss(preds_A, preds_B, flow_gt, valid,
                                      flow_gt_B, valid_B, gamma)
            loss.backward()
            loss = loss.detach()
        for p in params:           # optax updates every parameter
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        clip_by_global_norm_(grads, norm, clip)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        optimizer.step()
        return {**metrics, "train/loss": loss, "train/grad_norm": norm}

    return train_step


@dataclass
class TrainerConfig:
    """The flags of ``prior_flow_tpu/train/trainer.py::TrainerConfig`` that
    the port runs (EFT recipe defaults)."""

    lr: float = 1e-4
    num_steps: int = 60000
    iters: int = 12
    wdecay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    gamma: float = 0.8
    grad_mode: str = "standard"
    mixed_precision: bool = False
    seed: int = 1234


class Trainer:
    """Model, optimizer and step counter; ``run`` trains over batches.

    Weights come from ``state_dict`` (reference layout, strict) or from
    the seeded init; the model lives on ``device`` (default: the card)."""

    def __init__(self, cfg: TrainerConfig, device=None, state_dict=None):
        self.cfg = cfg
        self.model = build_model(device, seed=cfg.seed, state_dict=state_dict,
                                 mixed_precision=cfg.mixed_precision).train()
        self.optimizer, self.schedule = make_optimizer(
            self.model.parameters(), cfg.lr, cfg.num_steps, cfg.wdecay,
            cfg.epsilon)
        self.step = 0
        self._step_fn = make_train_step(
            self.model, self.optimizer, self.schedule, cfg.iters, cfg.gamma,
            cfg.grad_mode, cfg.clip)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        dev = self.device
        metrics = self._step_fn(tuple(t.to(dev) for t in batch), self.step)
        self.step += 1
        return metrics

    def run(self, batches: Iterable,
            log: Optional[Callable[[Dict[str, float], int], None]] = None):
        """One step per batch (image1, image2, flow_gt, valid), until the
        batches end or ``num_steps`` is reached; ``log(metrics, step)``
        gets host floats after each step. Returns the last metrics."""
        metrics = {}
        for batch in batches:
            if self.step >= self.cfg.num_steps:
                break
            metrics = self.train_step(batch)
            if log is not None:
                log({k: float(v) for k, v in metrics.items()}, self.step - 1)
        return metrics

    def save(self, path: str) -> None:
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "step": self.step}, path)

    def load(self, path: str) -> None:
        """Resume {model, optimizer, step} from ``save``'s file."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
