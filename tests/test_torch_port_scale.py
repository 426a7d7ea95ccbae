"""The memory-scale modes of the port against the JAX package on the CPU:
on-the-fly correlation (``corr_mode="onthefly"``, ``ops.corr.DCCLOnTheFly``)
and rematerialisation (``remat``, ``remat_policy``).

Tolerances:
- the on-the-fly call against JAX's, unit-scale features: own taps 1e-5
  abs (both read the same bilinear corners and differ in the order of the
  f32 sums); cross taps 1e-4 abs, for the window-coords rounding of
  ROADMAP Queue 3 (the port's coords op wraps centre + offset, JAX's
  one-hot window takes the wrapped centre's fraction first);
- chunked against unchunked: bitwise (every query's arithmetic is the
  same);
- the tap Function's VJP against float64 autograd of the plain
  composition (sampler, einsum): 1e-12 relative to max|reference|;
- the on-the-fly model against JAX's: 1e-3 x flow scale, the port's
  forward gate (``test_torch_port_model.FLOW_TOL``);
- on-the-fly against the port's volume route: JAX's contract, 1e-4 x flow
  scale + 1e-4 (``tests/test_model.py:100-115``), and the training
  gradients at 1e-4 relative L2 per tensor, norms floored at 1e-6 of the
  global norm and at 1e-2 for the fnet conv biases in front of an instance
  norm (zero in exact arithmetic);
- remat against no remat: JAX's contract, rtol 2e-4 / atol 2e-6 per
  element (``tests/test_model.py:156-181``).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
from prior_flow_tpu.ops.corr import DCCLOnTheFly as JaxDCCLOnTheFly
from prior_flow_tpu_torch.checkpoint import state_dict_from_jax
from prior_flow_tpu_torch.cli import train as tcli
from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.models import PriOrRAFT, build_model
from prior_flow_tpu_torch.ops import corr
from prior_flow_tpu_torch.ops.kernels import dccl_coords, library
from prior_flow_tpu_torch.ops.kernels.dccl_lookup import window_delta
from prior_flow_tpu_torch.ops.samplers import cycle_bilinear_sample
from prior_flow_tpu_torch.train import (make_optimizer, make_train_step,
                                        taped_value_and_grad)
from test_torch_port_nn import random_variables
from test_torch_port_ops import _centres
from test_torch_port_train import _batch

OWN_ATOL, CROSS_ATOL = 1e-5, 1e-4
F64_RTOL = 1e-12
FLOW_TOL = 1e-3
OTF_GRAD_RTOL = 1e-4
REMAT_RTOL, REMAT_ATOL = 2e-4, 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small shapes: more buy
    nothing here, and where the suite's worker processes share the cores
    their threads wait on each other at every op (238 s against 72 s for
    three of these tests beside five busy processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(rng, B, h, w, C):
    return [rng.normal(size=(B, h, w, C)).astype(np.float32)
            for _ in range(4)]


def _port_call(otf, feats, cens, h, w, L):
    """The port's both-branch call on numpy inputs at an (8h, 8w) image's
    grids: (own_A, cross_A, own_B, cross_B) as numpy."""
    g = rotation_grids(8 * h, 8 * w).to_device("cpu")
    t = [torch.from_numpy(f) for f in feats]
    pA = corr.DCCLOnTheFly.build_pyramid(t[0], t[1], L)
    pB = corr.DCCLOnTheFly.build_pyramid(t[2], t[3], L)
    out = otf(*(torch.from_numpy(c) for c in cens), pA, pB, g.a2b_w2c_8,
              g.b2a_w2c_8, g.a2b_8, g.b2a_8)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("B,C,L", [(1, 32, 4), (2, 32, 3)])
def test_onthefly_matches_jax(B, C, L):
    """The port's DCCLOnTheFly against JAX's, called once per branch, at an
    8x16 grid (the real 64x128 rotation grids), centres over the image, its
    margin, the seam and the pole rows."""
    rng = np.random.default_rng(L)
    h, w = 8, 16
    feats = _features(rng, B, h, w, C)
    cens = [_centres(rng, B * h * w, h, w).reshape(B, h, w, 2)
            for _ in range(2)]
    got = _port_call(corr.DCCLOnTheFly(L), feats, cens, h, w, L)

    g = jgrids.rotation_grids(8 * h, 8 * w)
    jf = [jnp.asarray(f) for f in feats]
    pA = JaxDCCLOnTheFly.build_pyramid(jf[0], jf[1], L)
    pB = JaxDCCLOnTheFly.build_pyramid(jf[2], jf[3], L)
    j = JaxDCCLOnTheFly(num_levels=L)
    ref = [*j(jnp.asarray(cens[0]), pA, pB, g.a2b_w2c_8, g.b2a_8),
           *j(jnp.asarray(cens[1]), pB, pA, g.b2a_w2c_8, g.a2b_8)]
    for name, a, b, tol in zip(("own_A", "cross_A", "own_B", "cross_B"),
                               got, ref, (OWN_ATOL, CROSS_ATOL) * 2):
        b = np.asarray(b)
        assert a.shape == b.shape == (B, h, w, L * 81)
        err = float(np.abs(a - b).max())
        print(f"{name}: max abs err {err:.3e} (max |ref| "
              f"{float(np.abs(b).max()):.3f}, gate {tol})")
        assert err <= tol, name


@pytest.mark.parametrize("query_chunk,n_chunks", [
    (32, 4), (48, 8), (-1, 1), (0, 1)])
def test_chunked_equals_unchunked(query_chunk, n_chunks, monkeypatch):
    """Query chunking is a restructure (``tests/test_corr.py:483-517``):
    Q // 4, a chunk that does not divide Q (gcd(128, 48) = 16), never, and
    the auto threshold, which leaves 128 queries whole; bitwise equal to
    the unchunked call, with one coords op per chunk."""
    rng = np.random.default_rng(1)
    B, h, w, C, L = 1, 8, 16, 32, 3
    feats = _features(rng, B, h, w, C)
    cens = [(rng.uniform(size=(B, h, w, 2)) * [w - 1.0, h - 1.0]).astype(
        np.float32) for _ in range(2)]
    dense = _port_call(corr.DCCLOnTheFly(L, query_chunk=-1), feats, cens, h,
                       w, L)
    calls = []
    plain = library.dccl_cross_coords_plain
    monkeypatch.setattr(library, "dccl_cross_coords_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    got = _port_call(corr.DCCLOnTheFly(L, query_chunk=query_chunk), feats,
                     cens, h, w, L)
    assert len(calls) == n_chunks
    assert all(s == (B, h * w // n_chunks, 2) for s in calls)
    for a, b in zip(got, dense):
        np.testing.assert_array_equal(a, b)
    assert corr.DCCLOnTheFly.QUERY_CHUNK_AUTO == \
        JaxDCCLOnTheFly.QUERY_CHUNK_AUTO


def _plain_taps(pA, pB, cA, cB, gA, gB, scales):
    """The plain composition the tap Function stands for, differentiable by
    autograd: per level, branch and side the sampler's bilinear features
    at the taps and their dot with f1 (``DCCLOnTheFly._tap_values``)."""
    B, Q, _ = cA.shape
    xA, yA, xB, yB = dccl_coords.dccl_cross_coords_plain(cA, cB, gA, gB,
                                                         scales)
    delta = window_delta().to(cA.dtype)
    out = [[], [], [], []]
    for lvl, s in enumerate(scales):
        rows = slice(lvl * B * Q, (lvl + 1) * B * Q)
        taps = [(cA * s)[:, :, None] + delta,
                torch.stack([xA[rows], yA[rows]], -1).view(B, Q, 81, 2),
                (cB * s)[:, :, None] + delta,
                torch.stack([xB[rows], yB[rows]], -1).view(B, Q, 81, 2)]
        for j, b in enumerate(corr.SIDE_BRANCH):
            pyr = (pA, pB)[b]
            feats = cycle_bilinear_sample(pyr[lvl][1], taps[j])
            out[j].append(torch.einsum("bqkc,bqc->bqk", feats, pyr[0][0]))
    return [torch.cat(o, -1) for o in out]


def test_tap_function_vjp_matches_float64_autograd():
    """``OnTheFlyTaps``' backward (the gathers read again, the corners'
    ``index_add_``) against autograd of the plain composition, float64,
    batch 2, 3 levels, two query chunks, the same cotangents."""
    rng = np.random.default_rng(2)
    B, h, w, C, L = 2, 8, 16, 8, 3
    Q = h * w
    fm = [torch.from_numpy(f).double().requires_grad_()
          for f in _features(rng, B, h, w, C)]
    cens = [torch.from_numpy(_centres(rng, B * Q, h, w)).double().view(B, Q, 2)
            for _ in range(2)]
    g = rotation_grids(8 * h, 8 * w).to_device("cpu")
    grids = (g.a2b_w2c_8.double(), g.b2a_w2c_8.double())
    scales = tuple(1.0 / 2 ** i for i in range(L))
    cts = [torch.from_numpy(rng.normal(size=(B, Q, L * 81))) for _ in range(4)]
    results = []
    for fn in ("function", "plain"):
        for f in fm:
            f.grad = None
        pA = corr.DCCLOnTheFly.build_pyramid(fm[0], fm[1], L)
        pB = corr.DCCLOnTheFly.build_pyramid(fm[2], fm[3], L)
        if fn == "function":
            f2s = [p[i][1] for i in range(L) for p in (pA, pB)]
            out = corr.OnTheFlyTaps.apply(
                *cens, *grids, scales, corr._query_chunks(Q, 64, 16384),
                pA[0][0], pB[0][0], *f2s)
        else:
            out = _plain_taps(pA, pB, *cens, *grids, scales)
        sum((o * c).sum() for o, c in zip(out, cts)).backward()
        results.append(([o.detach() for o in out], [f.grad for f in fm]))
    for a, b in zip(results[0][0] + results[0][1],
                    results[1][0] + results[1][1]):
        assert float((a - b).abs().max()) <= F64_RTOL * float(b.abs().max())


@pytest.fixture(scope="module")
def onthefly_models():
    """JAX's on-the-fly PriOrRAFT (precision "highest") with random
    variables, and the port's with the same weights."""
    jm = JaxPriOrRAFT(precision="highest", corr_mode="onthefly")
    img = jnp.zeros((1, 64, 128, 3))
    variables = random_variables(jm, img, img, iters=1)
    tm = build_model("cpu", state_dict=state_dict_from_jax(variables),
                     precision="highest", corr_mode="onthefly")
    return jm, variables, tm


def _pair(seed, H, W, B=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
                 for _ in range(2))


def test_onthefly_model_matches_jax(onthefly_models):
    """The test-mode forward at 64x128, 2 iterations, f32, against JAX's
    ``PriOrRAFT(corr_mode="onthefly")``. (At 32x64 JAX's on-the-fly
    pyramid cannot pool its 1x2 third level; the port's drops the odd row,
    as the volume route's pooling does.)"""
    jm, variables, tm = onthefly_models
    i1, i2 = _pair(4, 64, 128)
    ref = np.asarray(jm.apply(variables, jnp.asarray(i1), jnp.asarray(i2),
                              iters=2, test_mode=True))
    got = tm(torch.from_numpy(i1), torch.from_numpy(i2), iters=2).numpy()
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    print(f"max abs err {err:.3e}, flow scale {scale:.3f}")
    assert got.shape == ref.shape == (1, 64, 128, 2)
    assert err <= FLOW_TOL * scale


def _grad_rel(g, ref):
    """Per tensor: |g - ref| / max(|ref|, floor), the floors of the module
    docstring."""
    total = float(sum((r.double() ** 2).sum() for r in ref.values())) ** 0.5
    out = {}
    for n, r in ref.items():
        zero = (n.startswith("fnet.") and n.endswith(".bias")
                and n != "fnet.conv2.bias")
        floor = (1e-2 if zero else 1e-6) * total
        out[n] = float((g[n] - r).norm()) / max(float(r.norm()), floor)
    return out


def _train_grads(model, batch, grad_mode="standard", iters=2):
    """Loss and parameter gradients of one step of ``make_train_step``
    (clip off, so the gradients are the loss's)."""
    opt, sched = make_optimizer(model.parameters(), 1e-4, 100)
    step = make_train_step(model, opt, sched, iters=iters,
                           grad_mode=grad_mode, clip=1e9)
    metrics = step(tuple(torch.from_numpy(a) for a in batch), 0)
    return float(metrics["train/loss"]), {
        n: p.grad.detach().clone() for n, p in model.named_parameters()}


def test_onthefly_equals_volume_route():
    """Exact by linearity: the port's on-the-fly route against its volume
    route (held to JAX elsewhere), the 32x64 test-mode forward at 3
    iterations (the empty fourth level included) and the gradients of a
    standard training step at batch 2."""
    vol = build_model("cpu", seed=5, precision="highest")
    otf = build_model("cpu", seed=5, precision="highest",
                      corr_mode="onthefly")
    i1, i2 = (torch.from_numpy(a) for a in _pair(6, 32, 64))
    a, b = vol(i1, i2, iters=3), otf(i1, i2, iters=3)
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) < 1e-4 * scale + 1e-4
    batch = _batch(seed=1, b=2, h=32, w=64)
    l_v, g_v = _train_grads(vol.train(), batch)
    l_o, g_o = _train_grads(otf.train(), batch)
    assert abs(l_o - l_v) <= 1e-5 * abs(l_v)
    rel = _grad_rel(g_o, g_v)
    worst = max(rel, key=rel.get)
    print(f"worst relative L2 gradient difference {rel[worst]:.3e} ({worst})")
    assert rel[worst] <= OTF_GRAD_RTOL


class _ConvCount(TorchDispatchMode):
    """Counts the convolution forwards that run while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("grad_mode", ["standard", "taped"])
def test_remat_policies_keep_gradients(grad_mode, monkeypatch):
    """``remat_policy`` "dccl" and "dots" against ``remat=False``, one step
    of ``make_train_step`` at 32x64, batch 2, 2 iterations, f32: the
    gradients within JAX's contract; the plain lookup runs once per
    iteration under every policy (none replayed); "dccl" runs the update
    blocks' convolutions again in the backward, "dots" keeps their outputs
    (as many convolutions as without remat)."""
    lookups = []
    plain = library.dccl_lookup_all_levels_plain
    monkeypatch.setattr(library, "dccl_lookup_all_levels_plain",
                        lambda *a: lookups.append(1) or plain(*a))
    batch = _batch(seed=2, b=2, h=32, w=64)
    res, convs = {}, {}
    for remat, policy in ((False, "dccl"), (True, "dccl"), (True, "dots")):
        model = build_model("cpu", seed=7, precision="highest", remat=remat,
                            remat_policy=policy).train()
        del lookups[:]
        with _ConvCount() as count:
            _, res[(remat, policy)] = _train_grads(model, batch, grad_mode)
        convs[(remat, policy)] = count.n
        print(f"{grad_mode} remat={remat} {policy}: {len(lookups)} lookups, "
              f"{count.n} convolutions")
        assert len(lookups) == 2
    base = convs[(False, "dccl")]
    assert convs[(True, "dccl")] > base and convs[(True, "dots")] == base
    ref = res[(False, "dccl")]
    for key in ((True, "dccl"), (True, "dots")):
        for n, g in res[key].items():
            np.testing.assert_allclose(g.numpy(), ref[n].numpy(),
                                       rtol=REMAT_RTOL, atol=REMAT_ATOL,
                                       err_msg=f"{key} {n}")


def test_taped_refuses_onthefly():
    """As JAX's ``taped_value_and_grad`` (``tests/test_model.py:347``)."""
    model = PriOrRAFT(corr_mode="onthefly")
    dummy = torch.zeros(1, 32, 64, 3)
    with pytest.raises(ValueError, match="volume"):
        taped_value_and_grad(model, dummy, dummy, None, None, None, None, 2,
                             0.8)


def test_unknown_modes_raise():
    with pytest.raises(ValueError, match="corr_mode"):
        PriOrRAFT(corr_mode="alt")
    with pytest.raises(ValueError, match="remat_policy"):
        PriOrRAFT(remat_policy="all")


def test_cli_remat_policy_reaches_the_model(tmp_path, monkeypatch):
    """``cli.train --remat_policy dots`` builds its model with that policy
    (the loader and the loop stubbed out); the default is "dccl", as in
    the JAX CLI; ``TrainerConfig(remat_policy="none")`` builds it without
    remat."""
    from prior_flow_tpu_torch.data import datasets
    from prior_flow_tpu_torch.train import trainer
    monkeypatch.setattr(datasets, "fetch_dataloader", lambda args: None)
    monkeypatch.setattr(trainer.Trainer, "run", lambda self, loader: {})
    argv = ["--stage", "EFT", "--save_path", str(tmp_path), "--device", "cpu"]
    for extra, want in (([], "dccl"), (["--remat_policy", "dots"], "dots")):
        model = tcli.main(argv + extra).model
        assert model.remat and model.remat_policy == want
        assert model.corr_mode == "volume"
    cfg = trainer.TrainerConfig(remat_policy="none", save_path=str(tmp_path))
    assert not trainer.Trainer(cfg, device="cpu").model.remat
