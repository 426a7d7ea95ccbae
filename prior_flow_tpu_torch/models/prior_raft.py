"""PriOr-RAFT (counterpart of ``prior_flow_tpu/models/prior_raft.py``).

Inputs are uint8-range RGB images (B, H, W, 3) in [0, 255], channels-last
as in the JAX package. ``test_mode=True`` returns the final upsampled
branch-A flow (B, H, W, 2), under no_grad; ``test_mode=False`` is the
training forward and returns both branches' per-iteration upsampled flows
stacked as (iters, B, H, W, 2), differentiable. ``encode`` and
``iterate_taped`` are the pieces of the taped backward
(``train/trainer.py::taped_value_and_grad``). Inside, the networks run
NCHW; coordinates, flows, flaw maps and lookups stay channels-last, the
layout the samplers take.

Mixed precision: ``torch.autocast(bfloat16)`` around the networks only.
Feature maps, the volume matmul, the lookups and the flaw maps stay f32,
and the pyramid is stored in bf16 (``prior_raft.py:385``), the split the
JAX package makes. Above ``LEAN_BUILD_QUERIES`` 1/8 queries (as at
1024x2048) the pyramids are built in query chunks
(``ops.corr.build_pyramid_lean``, ``prior_raft.py:394-409``), and there
the 1/8 grid is wider than 128 columns, so ``DCCLFused`` takes its planes
route.

Deferred volume gradients (``deferred_vol_grad``, ``prior_raft.py:156-164,
386-395,486-540``): a training forward on the ``DCCLFused`` volume route
runs in the three stages of JAX's ``_forward_deferred``:
(a) ``_record_and_rebind``'s recording pass under
``torch.no_grad()``, the same recurrence through ``DCCLFused.record``,
without mask heads or upsampling, keeping every iteration's summed fields
and centres; (b) ``ops.corr.DCCLDeferredRebind``, the identity on the
stacked fields whose backward is ONE stacked scatter per level and volume
(``ops.corr.stacked_volume_cotangents``, which the taped backward shares);
(c) the replay, ``_recur`` with the rebound fields in place of the lookups,
in the same checkpoint regions as the standard path. The gradients are
the standard path's: the lookup is linear in the volume and the coords
are detached every iteration. Under mixed precision the pyramids are built
in query chunks at every size (``:394-395``; the dense build's bits).
The ``mxu`` / ``gather`` lookups and ``corr_mode="onthefly"`` take the
standard path, and the taped backward ignores the field, as in JAX.

BatchNorm (``bn_running_average``, ``prior_raft.py:137,172``): ``True``,
the default, freezes the context encoder's norms at their running
statistics (``nn.layers.FrozenBatchNorm``); ``False`` normalises by each
call's batch statistics and updates the running ones
(``nn.layers.BatchNorm``).

Correlation (``corr_mode``, ``prior_raft.py:150-155,386-399``):
``"volume"`` (the default) builds both branches' volume pyramids once and
looks them up with ``DCCLFused``; ``"onthefly"`` keeps f32 feature
pyramids (no volume, no lean build, no bf16 storage, as JAX builds them
from the f32 fmaps) and computes every tap's correlation from them with
``ops.corr.DCCLOnTheFly``: O(HW C) memory, the route for inputs whose
volumes outgrow the card (2048x4096).

Rematerialisation (``remat``, ``remat_policy``, ``prior_raft.py:138-141,
446-448,468-484``), in a training forward and ``iterate_taped`` only, and
only while autograd records: each GRU iteration's lookup runs outside a
``torch.utils.checkpoint`` region and its fields enter the region as
inputs; the flaw maps, ``flo_rotate``, both update blocks and the
upsampling run inside it and run again in the backward. ``"dccl"`` keeps
only the region's inputs (the lookup results among them; the lookups
themselves keep their centres), ``"dots"`` also every convolution and
matrix product output inside it (selective checkpointing). Neither
replays a lookup. The replay runs under the forward's autocast state;
the caller keeps the precision flags (``train/trainer.py`` runs the
backward inside ``precision_scope``).

Lookup (``lookup_mode``, ``prior_raft.py:145-149,176-190``): ``"auto"``
and ``"pallas"`` take ``DCCLFused``, the CUDA lookup kernels, on the card
and their plain versions on the CPU; ``"mxu"`` (one-hot matrix products)
and ``"gather"`` (plain gathers) take ``ops.corr.DCCL`` once per branch,
no kernel, the route a program exported for several device types needs
(``serving.export_forward(platforms=)``). JAX's ``"auto"`` is ``"mxu"``
off the TPU; the port's stays the kernel route everywhere, the same
function (ROADMAP Queue 3, "Kept on purpose"). ``corr_mode="onthefly"``
takes precedence, as in JAX; the taped backward needs the kernel route.

Dropout (``dropout`` > 0) acts in the encoders of the training forward
only, in train mode, and draws from the ``generator`` the caller passes
(the trainer keys one by (seed, step)); a training forward in train mode
without one raises. Test-mode forwards and eval mode never drop.

Height sharding (the ``space`` axis of a data x space mesh,
``parallel/spatial.py``): inside a ``spatial.scope`` the forward takes
this rank's real rows of each image (``spatial.shard_rows``: strips of
8 * ceil(H / (8 S)) rows, the last short or empty, for any H a multiple
of 8 and of S) and returns its rows of the flow. It sets the scope's
height from them, pads them to the rank's strip and cuts the flows
back to its real rows (``spatial.enter``, ``Space.pad`` / ``crop``);
pad rows are read by no real row. Every convolution and instance norm, the
orthogonal view, ``flo_rotate``, the back-rotation and the upsampling
exchange rows with the other ranks; fmap2 is gathered once per forward
(the volume's targets, the flaw maps' warps); the queries, the volume
rows, the lookups and ``coords0`` are the rank's, in global pixels; the
grids are the whole image's. Every option runs sharded: the deferred
path records the rank's queries (global centres) and its rebind scatters
into the rank's volume rows, the back-rotation's transpose through the
sharded ``resample_static``; the ``mxu`` / ``gather`` lookups read the
rank's volume rows; ``bn_running_average=False`` takes the global
batch's statistics (``nn.layers.BatchNorm``); ``iterate_taped`` runs the
rank's rows as the standard loop does.

Precision (``prior_raft.py:142-144``): ``precision=None`` runs under
torch's backend flags as the caller left them (torch's default lets cuDNN
convolutions use TF32); ``"highest"`` runs the forward, and a training
step (``train/trainer.py``), with TF32 off for cuDNN convolutions and for
matmuls, as JAX's ``jax.default_matmul_precision('highest')`` does, then
puts the caller's flags back.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry import grids as gridlib
from ..nn.encoder import BasicEncoder
from ..nn.update import BasicMultiUpdateBlock, BasicUpdateBlock
from ..ops.corr import (DCCL, DCCLDeferredRebind, DCCLFused, DCCLOnTheFly,
                        all_pairs_correlation, build_pyramid,
                        build_pyramid_lean, groupwise_corr)
from ..ops.samplers import cycle_bilinear_sample
from ..ops.warp import flo_rotate, img_rotate
from ..parallel import spatial
from ..utils.precision import check_precision, precision_scope


# above this many 1/8 queries (H*W/64) the pyramids are built in query
# chunks, as in the JAX package (``prior_raft.py:394``): the dense build's
# f32 volume and f32 pyramid would not fit beside each other before the
# cast on the device the JAX package sized it for
LEAN_BUILD_QUERIES = 16384
CORR_MODES = ("volume", "onthefly")
LOOKUP_MODES = ("auto", "pallas", "mxu", "gather")
REMAT_POLICIES = ("dccl", "dots")
# the ops whose outputs the "dots" policy keeps: JAX's ``dots_saveable``
# saves every dot_general and convolution (``prior_raft.py:469-479``)
_DOT_OPS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.baddbmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    """The "dots" policy of ``create_selective_checkpoint_contexts``."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_keep_dots)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor):
    """Convex-combination 8x upsampling (``prior_raft.py:58``).

    flow: (B, h, w, 2); mask: (B, h, w, 576) ordered (9, 8, 8) channel-major
    -> (B, 8h, 8w, 2). Neighbourhoods in F.unfold order k = ky*3 + kx.
    """
    B, h, w, C = flow.shape
    m = mask.permute(0, 3, 1, 2).float().reshape(B, 1, 9, 8, 8, h, w)
    m = torch.softmax(m, dim=2)
    f = (8.0 * flow).permute(0, 3, 1, 2).float()
    space = spatial.current()
    if space is None:
        neigh = F.unfold(f, [3, 3], padding=1)
    else:   # one halo row above and below for the 3x3 neighbourhoods
        neigh = F.unfold(spatial.halo_rows(f, 1, 1, 2, space), [3, 3],
                         padding=(0, 1))
    neigh = neigh.reshape(B, C, 9, 1, 1, h, w)
    up = torch.sum(m * neigh, dim=2)                      # (B, C, 8, 8, h, w)
    up = up.permute(0, 4, 2, 5, 3, 1)                     # (B, h, 8, w, 8, C)
    return up.reshape(B, 8 * h, 8 * w, C).to(flow.dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class StepConsts(NamedTuple):
    """Loop-invariant inputs of every GRU iteration."""

    inp_A: torch.Tensor
    inp_B: torch.Tensor
    fmap1_A: torch.Tensor
    fmap2_A: torch.Tensor
    coords0: torch.Tensor
    grids: gridlib.RotationGrids


class PriOrRAFT(nn.Module):
    """Dual-branch RAFT with DCCL and ODDC; attribute names are the
    reference's (``fnet``, ``cnet``, ``ODDC``, ``update_block``)."""

    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, mixed_precision: bool = False,
                 precision: Optional[str] = None, corr_mode: str = "volume",
                 remat: bool = True, remat_policy: str = "dccl",
                 lookup_mode: str = "auto", bn_running_average: bool = True,
                 deferred_vol_grad: bool = False):
        super().__init__()
        check_precision(precision)
        if corr_mode not in CORR_MODES:
            raise ValueError(f"corr_mode must be one of {CORR_MODES}, got "
                             f"{corr_mode!r}")
        if lookup_mode not in LOOKUP_MODES:
            raise ValueError(f"lookup_mode must be one of {LOOKUP_MODES}, "
                             f"got {lookup_mode!r}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                             f"got {remat_policy!r}")
        self.precision = precision
        self.bn_running_average = bn_running_average
        self.corr_mode = corr_mode
        self.lookup_mode = lookup_mode
        self.remat = remat
        self.remat_policy = remat_policy
        self.deferred_vol_grad = deferred_vol_grad
        self.hidden_dim = hidden_dim
        self.corr_levels = corr_levels
        self.mixed_precision = mixed_precision
        corr_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.dropout = dropout
        self.fnet = BasicEncoder(256, "instance", dropout=dropout)
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch",
                                 dropout=dropout,
                                 use_running_average=bn_running_average)
        self.ODDC = BasicMultiUpdateBlock(hidden_dim, corr_planes)
        self.update_block = BasicUpdateBlock(hidden_dim, corr_planes)
        if corr_mode == "onthefly":
            self.dccl = DCCLOnTheFly(corr_levels, corr_radius)
        elif lookup_mode in ("auto", "pallas"):
            self.dccl = DCCLFused(corr_levels, corr_radius)
        else:
            self.dccl = DCCL(corr_levels, corr_radius, lookup_mode)
        self._grids = {}

    def _autocast(self, device):
        return torch.autocast(device.type, dtype=torch.bfloat16,
                              enabled=self.mixed_precision)

    def dropout_generator(self, generator):
        """The generator a training forward's encoders drop out from:
        ``generator`` in train mode with dropout on, else None."""
        if not (self.training and self.dropout > 0):
            return None
        if generator is None:
            raise ValueError("dropout in training draws from an explicit "
                             "generator: pass generator=")
        return generator

    def rotation_grids(self, H: int, W: int, device) -> gridlib.RotationGrids:
        """The (H, W) grid bundle on ``device``, copied there once."""
        key = (H, W, str(device))
        if key not in self._grids:
            self._grids[key] = gridlib.rotation_grids(H, W).to_device(device)
        return self._grids[key]

    def encode(self, image1, image2, g: gridlib.RotationGrids,
               generator=None):
        """Normalisation, orthogonal view and both encoders
        (``prior_raft.py:342``). Returns NCHW ``net_A, net_B, inp_A,
        inp_B`` and the channels-last f32 fmaps (fmap1_A, fmap2_A, fmap1_B,
        fmap2_B). Given a ``generator`` (``dropout_generator``'s), the
        encoders drop out from it, the context encoder first."""
        image1_A = 2.0 * (image1 / 255.0) - 1.0
        image2_A = 2.0 * (image2 / 255.0) - 1.0
        rotated = img_rotate(torch.cat([image1_A, image2_A], dim=-1), g.a2b)
        image1_B, image2_B = rotated[..., :3], rotated[..., 3:]
        views = [_nchw(v).contiguous()
                 for v in (image1_A, image2_A, image1_B, image2_B)]
        with self._autocast(image1.device):
            cnet_A, cnet_B = self.cnet([views[0], views[2]], generator)
            fmaps = self.fnet(views, generator)
        hd = self.hidden_dim
        net_A, inp_A = torch.tanh(cnet_A[:, :hd]), F.relu(cnet_A[:, hd:])
        net_B, inp_B = torch.tanh(cnet_B[:, :hd]), F.relu(cnet_B[:, hd:])
        fmaps = tuple(_nhwc(f.float()).contiguous() for f in fmaps)
        return net_A, net_B, inp_A, inp_B, fmaps

    def build_pyramids(self, fmaps, lean: bool = False):
        """Both branches' 4-level pyramids from the channels-last fmaps,
        differentiable when autograd records. Volume pyramids are stored in
        bf16 under mixed precision (``prior_raft.py:385``) and built in
        query chunks above ``LEAN_BUILD_QUERIES`` queries or with ``lean``
        (``prior_raft.py:394-414``; the same bits as the dense build); with
        ``corr_mode="onthefly"`` the f32 feature pyramids of
        ``DCCLOnTheFly.build_pyramid``."""
        fmap1_A, fmap2_A, fmap1_B, fmap2_B = fmaps
        pairs = ((fmap1_A, fmap2_A), (fmap1_B, fmap2_B))
        if self.corr_mode == "onthefly":
            return tuple(DCCLOnTheFly.build_pyramid(f1, f2, self.corr_levels)
                         for f1, f2 in pairs)
        dt = torch.bfloat16 if self.mixed_precision else torch.float32
        # the whole image's 1/8 size (fmap2 is gathered when height-sharded)
        _, h8, w8, _ = fmap2_A.shape
        if lean or h8 * w8 > LEAN_BUILD_QUERIES:
            return tuple(build_pyramid_lean(f1, f2, self.corr_levels, dt)
                         for f1, f2 in pairs)
        return tuple([p.to(dt).contiguous() for p in build_pyramid(
            all_pairs_correlation(f1, f2), self.corr_levels)]
            for f1, f2 in pairs)

    def _step(self, net_A, net_B, coords1_A, coords1_B, k: StepConsts,
              corr_fn, mask_A: bool, mask_B: bool, upsample: bool):
        """One GRU iteration (``prior_raft.py:193-277``). ``corr_fn(c_A,
        c_B)`` returns both branches' summed own + cross fields. The coords
        are detached first (``:215,220``): no gradient runs along the
        trajectory. The lookup runs here, the rest in ``_update``, inside a
        checkpoint region when the model rematerialises and autograd
        records."""
        coords1_A = coords1_A.detach()
        coords1_B = coords1_B.detach()
        corr_A, corr_B = corr_fn(coords1_A, coords1_B)
        args = (net_A, net_B, coords1_A, coords1_B, corr_A, corr_B, k,
                mask_A, mask_B, upsample)
        if not (self.remat and torch.is_grad_enabled()):
            return self._update(*args)
        from torch.utils.checkpoint import checkpoint, noop_context_fn
        ctx = _dots_context if self.remat_policy == "dots" else noop_context_fn
        # the region draws no random numbers: dropout acts in the encoders
        return checkpoint(self._update, *args, use_reentrant=False,
                          context_fn=ctx, preserve_rng_state=False)

    def _update(self, net_A, net_B, coords1_A, coords1_B, corr_A, corr_B,
                k: StepConsts, mask_A: bool, mask_B: bool, upsample: bool):
        """The iteration after its lookup: flaw maps, ``flo_rotate``, both
        update blocks, the new coords and, with ``upsample``, both
        branches' upsampled flows in place of the masks."""
        g = k.grids
        flow_A = coords1_A - k.coords0
        warped_A = cycle_bilinear_sample(k.fmap2_A, coords1_A)
        flaw_A = groupwise_corr(k.fmap1_A, warped_A, num_groups=4)

        flow_B = coords1_B - k.coords0
        flow_B_A = flo_rotate(flow_B, g.b2a_w2c_8, g.b2a_8)
        warped_B_A = cycle_bilinear_sample(k.fmap2_A, k.coords0 + flow_B_A)
        flaw_B_A = groupwise_corr(k.fmap1_A, warped_B_A, num_groups=4)

        with self._autocast(coords1_A.device):
            net_A, up_mask_A, delta_A = self.ODDC(
                net_A, k.inp_A, _nchw(flow_A), _nchw(corr_A), _nchw(flaw_A),
                _nchw(flow_B_A), _nchw(flaw_B_A), with_mask=mask_A)
            net_B, up_mask_B, delta_B = self.update_block(
                net_B, k.inp_B, _nchw(corr_B), _nchw(flow_B),
                with_mask=mask_B)
        coords1_A = coords1_A + _nhwc(delta_A)
        coords1_B = coords1_B + _nhwc(delta_B)
        if upsample:
            up_mask_A = upsample_flow_convex(coords1_A - k.coords0,
                                             _nhwc(up_mask_A))
            up_mask_B = upsample_flow_convex(coords1_B - k.coords0,
                                             _nhwc(up_mask_B))
        return net_A, net_B, coords1_A, coords1_B, up_mask_A, up_mask_B

    def _recur(self, net_A, net_B, coords1_A, coords1_B, k: StepConsts,
               corr_fn, iters: int, train: bool):
        """The GRU loop. ``train``: both mask heads every iteration and
        both branches upsampled each time, stacked (iters, B, H, W, 2)
        (``_step``, ``prior_raft.py:279-287``); otherwise only branch A's
        last mask and one final upsample (``_step_test``)."""
        preds_A, preds_B, mask = [], [], None
        for it in range(iters):
            last = it == iters - 1
            net_A, net_B, coords1_A, coords1_B, out_A, out_B = self._step(
                net_A, net_B, coords1_A, coords1_B, k, corr_fn,
                mask_A=train or last, mask_B=train, upsample=train)
            if train:
                preds_A.append(out_A)
                preds_B.append(out_B)
            elif last:
                mask = _nhwc(out_A)
        if train:
            return torch.stack(preds_A), torch.stack(preds_B)
        return upsample_flow_convex(coords1_A - k.coords0, mask)

    def forward(self, image1, image2, iters: int = 12,
                init_flow: Optional[torch.Tensor] = None,
                test_mode: bool = True, generator=None):
        """``generator``: the dropout draws of a training forward
        (``test_mode=False``) in train mode."""
        if iters < 1:
            raise ValueError("iters must be at least 1")
        grad = torch.no_grad() if test_mode else contextlib.nullcontext()
        with precision_scope(self.precision), grad:
            return self._forward(image1, image2, iters, init_flow,
                                 not test_mode, generator)

    def _forward(self, image1, image2, iters, init_flow, train: bool,
                 generator=None):
        B, H, W, _ = image1.shape
        dev = image1.device
        space = spatial.current()
        if space is not None:   # the rank's real rows -> its strip
            space = spatial.enter(H, dev)
            H = space.height
            image1, image2 = space.pad(image1, 1), space.pad(image2, 1)
            if init_flow is not None:
                init_flow = space.pad(init_flow, 1, 8)
        g = self.rotation_grids(H, W, dev)
        net_A, net_B, inp_A, inp_B, fmaps = self.encode(
            image1, image2, g,
            self.dropout_generator(generator) if train else None)
        if space is not None:   # the targets: fmap2 of the whole image
            fmaps = (fmaps[0], spatial.gather_rows(fmaps[1], 1, space),
                     fmaps[2], spatial.gather_rows(fmaps[3], 1, space))
        deferred = (self.deferred_vol_grad and train
                    and isinstance(self.dccl, DCCLFused)
                    and self.corr_mode != "onthefly")
        pyr_A, pyr_B = self.build_pyramids(
            fmaps, lean=deferred and self.mixed_precision)

        h8, w8 = fmaps[0].shape[1], W // 8
        if space is None:
            coords0 = gridlib.identity_grid_on(h8, w8, dev)
        else:
            coords0 = spatial.identity_rows(h8, w8, dev, space)
        coords0 = coords0.expand(B, h8, w8, 2)
        coords1_A = coords0
        coords1_B = coords0
        if init_flow is not None:
            coords1_A = coords1_A + init_flow
            coords1_B = coords1_B + flo_rotate(init_flow, g.a2b_w2c_8, g.a2b_8)

        def corr_fn(c_A, c_B):
            if isinstance(self.dccl, DCCL):      # one branch per call
                own_A, cross_A = self.dccl(c_A, pyr_A, pyr_B, g.a2b_w2c_8,
                                           g.b2a_8)
                own_B, cross_B = self.dccl(c_B, pyr_B, pyr_A, g.b2a_w2c_8,
                                           g.a2b_8)
            else:
                own_A, cross_A, own_B, cross_B = self.dccl(
                    c_A, c_B, pyr_A, pyr_B, g.a2b_w2c_8, g.b2a_w2c_8,
                    g.a2b_8, g.b2a_8)
            return own_A + cross_A, own_B + cross_B

        k = StepConsts(inp_A, inp_B, fmaps[0], fmaps[1], coords0, g)
        if deferred:
            corr_fn = self._record_and_rebind(
                net_A, net_B, coords1_A, coords1_B, k, pyr_A, pyr_B, iters)
        out = self._recur(net_A, net_B, coords1_A, coords1_B, k, corr_fn,
                          iters, train)
        if space is None:
            return out
        if train:   # the rank's real rows of the flows
            return tuple(space.crop(p, 2) for p in out)
        return space.crop(out, 1)

    def _record_and_rebind(self, net_A, net_B, coords1_A, coords1_B,
                           k: StepConsts, pyr_A, pyr_B, iters: int):
        """Stages (a) and (b) of the deferred path (JAX's
        ``_forward_deferred``, ``prior_raft.py:486-540``): the recording
        pass without gradients through ``DCCLFused.record``, the same
        recurrence as the replay (``_step`` under the caller's autocast and
        precision, coords detached each iteration; no mask heads, no
        upsampling), then ``DCCLDeferredRebind`` on the stacked fields.
        Returns the replay's ``corr_fn``, which hands out iteration s's
        rebound fields and runs no lookup."""
        g = k.grids
        rec = []    # per iteration ((field_A, field_B), (cen_A, cen_B))

        def record(c_A, c_B):
            rec.append(self.dccl.record(c_A, c_B, pyr_A, pyr_B, g.a2b_w2c_8,
                                        g.b2a_w2c_8, g.a2b_8, g.b2a_8))
            return rec[-1][0]

        with torch.no_grad():
            state = (net_A, net_B, coords1_A, coords1_B)
            for _ in range(iters):
                state = self._step(*state, k, record, mask_A=False,
                                   mask_B=False, upsample=False)[:4]
        stacked = [torch.stack([r[i][j] for r in rec])
                   for i in range(2) for j in range(2)]
        del rec
        vols = [v for i in range(self.corr_levels)
                for v in (pyr_A[i], pyr_B[i])]
        fields_A, fields_B = DCCLDeferredRebind.apply(*stacked, g, *vols)
        taps = iter(zip(fields_A.unbind(0), fields_B.unbind(0)))
        return lambda c_A, c_B: next(taps)

    def iterate_taped(self, net_A, net_B, inp_A, inp_B, fmap1_A, fmap2_A,
                      pyr_A, pyr_B, iters: int = 12):
        """GRU loop of the taped backward (``prior_raft.py:542-587``).

        The standard differentiable recurrence, except that the lookups run
        primal-only on the (detached) pyramids through ``DCCLFused.record``
        and each iteration's summed fields become autograd leaves: after
        ``backward`` their ``.grad`` holds exactly the per-iteration field
        cotangents that one stacked scatter per level and branch turns into
        the volume cotangents. Returns ``((preds_A, preds_B), (fields_A,
        fields_B), (cen_A, cen_B))``: stacked (iters, B, H, W, 2) flows, the
        lists of field leaves (B, h8, w8, L*81), and the stacked
        (iters, B, Q, 2) centres. Height-sharded (a ``spatial.scope``
        with a height), everything but ``fmap2_A`` (the whole image's)
        holds the rank's strip, the flows too; the centres are global
        pixels of its queries."""
        B, _, h8, w8 = net_A.shape
        dev = net_A.device
        space = spatial.current()
        if space is None:
            coords0 = gridlib.identity_grid_on(h8, w8, dev)
        else:
            coords0 = spatial.identity_rows(h8, w8, dev, space)
        g = self.rotation_grids(8 * fmap2_A.shape[1], 8 * w8, dev)
        coords0 = coords0.expand(B, h8, w8, 2)
        pyr_A = [p.detach() for p in pyr_A]
        pyr_B = [p.detach() for p in pyr_B]
        fields_A, fields_B, cens_A, cens_B = [], [], [], []

        def corr_fn(c_A, c_B):
            (f_A, f_B), (cen_A, cen_B) = self.dccl.record(
                c_A, c_B, pyr_A, pyr_B, g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8,
                g.b2a_8)
            fields_A.append(f_A.requires_grad_())
            fields_B.append(f_B.requires_grad_())
            cens_A.append(cen_A)
            cens_B.append(cen_B)
            return f_A, f_B

        k = StepConsts(inp_A, inp_B, fmap1_A, fmap2_A, coords0, g)
        preds = self._recur(net_A, net_B, coords0, coords0, k, corr_fn,
                            iters, train=True)
        return (preds, (fields_A, fields_B),
                (torch.stack(cens_A), torch.stack(cens_B)))
