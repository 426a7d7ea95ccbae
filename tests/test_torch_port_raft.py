"""The port's legacy RAFT family and its blocks against the JAX package on
the CPU: ``corr_block_lookup``, the 'group' / 'none' norms and
batch-statistics BatchNorm, ``BottleneckBlock``, ``SmallEncoder``,
``ConvGRU``, ``SmallUpdateBlock``, and ``RAFT`` basic and small, with the
same weights (random Flax variables drawn with numpy, pushed through
``state_dict_from_jax`` and loaded strictly), in outputs and, for the
blocks, input and parameter gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prior_flow_tpu.checkpoint.convert import export_state_dict
from prior_flow_tpu.models import RAFT as JaxRAFT
from prior_flow_tpu.models import corr_block_lookup as jax_lookup
from prior_flow_tpu.nn import encoder as jenc
from prior_flow_tpu.nn import layers as jlayers
from prior_flow_tpu.nn import update as jupd
from prior_flow_tpu_torch.checkpoint import (state_dict_from_jax,
                                             strip_module_prefix)
from prior_flow_tpu_torch.models import (RAFT, build_model, build_raft,
                                         corr_block_lookup)
from prior_flow_tpu_torch.nn import encoder, layers, update
from test_torch_port_nn import ATOL, _nchw, _nhwc, random_variables

GRAD_RTOL = 1e-4   # relative L2 of each input / parameter gradient
GRAD_FLOOR = 1e-6  # reference norms floored at this share of the global
ZERO_BIAS_FLOOR = 1e-2
FLOW_TOL = 1e-4    # RAFT: max abs error as a fraction of max|flow|
H, W, ITERS = 64, 128, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``test_torch_port_scale.py``: the suite's
    worker processes share the cores, and beside five busy processes on 8
    cores more threads wait on each other at every op (this module's
    deferred test took 341 s so, ~5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12))


def _check_grads(japply, variables, tmod, xs, mutable=False,
                 zero_biases=False):
    """Output, input gradients and parameter gradients of ``tmod`` (NCHW,
    loaded with ``variables``) against ``japply(variables, *inputs)``
    (NHWC) at the NHWC numpy inputs ``xs``, for the loss sum(out * w) with
    a fixed random w. Each parameter gradient's reference norm is floored
    at ``GRAD_FLOOR`` of the global one; with ``zero_biases`` the conv
    biases, each in front of a norm that subtracts its channel's mean
    (instance, batch statistics) and so of zero gradient in exact
    arithmetic, at ``ZERO_BIAS_FLOOR`` of it. ``mutable``: the Flax
    module updates ``batch_stats`` (``japply`` then takes ``mutable=``
    and returns them too); returns JAX's new ones, after the one update
    the port's forward made too."""
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}
    jxs = [jnp.asarray(x) for x in xs]

    def f(p, *a):
        v = {"params": p, **rest}
        if mutable:
            return japply(v, *a, mutable=["batch_stats"])
        return japply(v, *a), None

    shape = jax.eval_shape(lambda: f(params, *jxs)[0]).shape
    w = np.random.default_rng(11).normal(size=shape).astype(np.float32)

    def loss(p, *a):
        out, stats = f(p, *a)
        return jnp.sum(out * w), (out, stats)

    # one compiled program: op by op, the encoders' VJPs take 10-20 s here
    (_, (out, new_stats)), (d_params, *d_xs) = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(xs) + 1)), has_aux=True))(params, *jxs)

    ins = [_nchw(x).requires_grad_() for x in xs]
    got = tmod(*ins)
    np.testing.assert_allclose(_nhwc(got.detach()), np.asarray(out),
                               atol=ATOL, rtol=0)
    (got * _nchw(w)).sum().backward()
    for t, r in zip(ins, d_xs):
        assert _rel(_nhwc(t.grad), np.asarray(r)) <= GRAD_RTOL
    ref_grads = state_dict_from_jax({"params": d_params})
    total = np.sqrt(sum(float((g.numpy() ** 2).sum())
                        for g in ref_grads.values()))
    for n, p in tmod.named_parameters():
        ref = ref_grads[n].numpy()
        if p.grad is None:            # a parameter the output does not read
            assert not ref.any(), n
            continue
        zero = zero_biases and n.endswith(".bias") and "norm" not in n
        floor = (ZERO_BIAS_FLOOR if zero else GRAD_FLOOR) * total
        err = float(np.linalg.norm(p.grad.numpy() - ref)
                    / max(np.linalg.norm(ref), floor))
        assert err <= GRAD_RTOL, (n, err)
    return new_stats


def _stats(sd):
    return {k: v for k, v in sd.items() if "running" in k}


# -- corr_block_lookup --------------------------------------------------------

def test_corr_block_lookup_matches_jax(rng):
    """8x16 grids, 3 levels, coords across and past every edge: the
    zero-padded (non-wrapping) window sampler, as upstream's CorrBlock."""
    B, h, w = 2, 8, 16
    vol = rng.normal(size=(B, h * w, h, w)).astype(np.float32)
    from prior_flow_tpu.ops.corr import build_pyramid as jpyr
    from prior_flow_tpu_torch.ops.corr import build_pyramid
    jp = tuple(jpyr(jnp.asarray(vol), 3))
    tp = build_pyramid(torch.from_numpy(vol), 3)
    coords = np.stack([rng.uniform(-3, w + 3, (B, h, w)),
                       rng.uniform(-3, h + 3, (B, h, w))],
                      -1).astype(np.float32)
    coords[0, 0, 0] = 0.0                     # windows past x = 0 and y = 0
    ref = np.asarray(jax_lookup(jp, jnp.asarray(coords)))
    got = corr_block_lookup(tp, torch.from_numpy(coords)).numpy()
    assert got.shape == ref.shape == (B, h, w, 3 * 81)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # taps left of x = 0 read zeros, not the wrapped right edge
    np.testing.assert_array_equal(got[0, 0, 0, 1:8], 0.0)


# -- norms --------------------------------------------------------------------

@pytest.mark.parametrize("features,groups", [
    pytest.param(64, None, id="features//8"),
    pytest.param(32, 8, id="stem-8"),
    pytest.param(16, 8, id="bottleneck-planes//8-of-planes//4")])
def test_group_norm_matches_flax(rng, features, groups):
    """Flax ``GroupNorm`` (eps 1e-5) at each of the encoders' group-count
    sites, output and gradients."""
    x = (rng.normal(size=(2, 6, 10, features)) * 2 + 0.5).astype(np.float32)
    jm = jlayers.make_norm("group", features, "n", num_groups=groups)
    v = random_variables(jm, jnp.asarray(x))
    tm = layers.make_norm("group", features, num_groups=groups)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    assert tm.num_groups == (groups or features // 8)
    _check_grads(jm.apply, v, tm, [x])


def test_batch_norm_batch_statistics_matches_flax(rng):
    """``use_running_average=False``: Flax's ``apply(...,
    mutable=["batch_stats"])``, its output and gradients and its updated
    statistics (momentum 0.9, the biased variance) after two calls; the
    frozen norm of the same weights differs."""
    x = (rng.normal(size=(4, 5, 7, 24)) * 3 - 1).astype(np.float32)
    jm = jlayers.make_norm("batch", 24, "n", use_running_average=False)
    v = random_variables(jm, jnp.asarray(x))
    tm = layers.make_norm("batch", 24, use_running_average=False)
    assert isinstance(tm, layers.BatchNorm)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    new = _check_grads(jm.apply, v, tm, [x], mutable=True)
    # one update per call: a second call on both sides
    _, new2 = jm.apply({"params": v["params"], **new}, jnp.asarray(x),
                       mutable=["batch_stats"])
    tm(_nchw(x))
    want = _stats(state_dict_from_jax(new2))
    for k, t in _stats(tm.state_dict()).items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    frozen = layers.make_norm("batch", 24)
    frozen.load_state_dict(tm.state_dict(), strict=True)
    assert not torch.allclose(frozen(_nchw(x)), tm(_nchw(x)))


def test_none_norm_is_identity():
    x = torch.randn(2, 3, 4, 5)
    assert torch.equal(layers.make_norm("none", 3)(x), x)
    with pytest.raises(ValueError):
        layers.make_norm("layer", 3)


# -- blocks -------------------------------------------------------------------

NORMS = ["group", "instance", "batch", "none"]


@pytest.mark.parametrize("norm_fn", NORMS)
@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_block_matches_flax(rng, norm_fn, stride):
    cin, planes = (16, 32) if stride == 2 else (32, 32)
    x = rng.normal(size=(2, 8, 12, cin)).astype(np.float32)
    jm = jenc.BottleneckBlock(cin, planes, norm_fn, stride=stride)
    v = random_variables(jm, jnp.asarray(x))
    tm = encoder.BottleneckBlock(cin, planes, norm_fn, stride=stride)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    _check_grads(jm.apply, v, tm, [x], zero_biases=norm_fn == "instance")


@pytest.mark.parametrize("norm_fn", NORMS)
def test_small_encoder_matches_flax(rng, norm_fn):
    """A list input (batched by concatenation and split back), the 'batch'
    norms on batch statistics; output, input and parameter gradients."""
    xs = [rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
          for _ in range(2)]
    kw = dict(output_dim=40, norm_fn=norm_fn, use_running_average=False)
    jm = jenc.SmallEncoder(**kw)
    v = random_variables(jm, [jnp.asarray(a) for a in xs])
    tm = encoder.SmallEncoder(**kw)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)

    def japply(variables, a, b, **k):
        out = jm.apply(variables, [a, b], **k)
        if k:
            return jnp.concatenate(out[0], axis=0), out[1]
        return jnp.concatenate(out, axis=0)

    tcat = lambda a, b: torch.cat(tm([a, b]), dim=0)
    tcat.named_parameters = tm.named_parameters
    new = _check_grads(japply, v, tcat, xs, mutable=norm_fn == "batch",
                       zero_biases=norm_fn in ("instance", "batch"))
    if norm_fn == "batch":
        port = tm.state_dict()
        for k, t in _stats(state_dict_from_jax(new)).items():
            np.testing.assert_allclose(port[k].numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_basic_encoder_batch_statistics_matches_flax(rng):
    """``BasicEncoder(use_running_average=False)`` (the context encoder of
    ``bn_running_average=False``) against JAX's ``apply(...,
    mutable=["batch_stats"])``: the output and every updated statistic."""
    x = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    jm = jenc.BasicEncoder(output_dim=48, norm_fn="batch",
                           use_running_average=False)
    v = random_variables(jm, jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        ref, new = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    tm = encoder.BasicEncoder(48, "batch", use_running_average=False)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=ATOL, rtol=0)
    want = _stats(state_dict_from_jax(new))
    port = tm.state_dict()
    assert len(want) == 2 * 15      # stem, 2 x 3 x 2 block norms, 2 downsample
    for k, t in want.items():
        np.testing.assert_allclose(port[k].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_conv_gru_matches_flax(rng):
    h = np.tanh(rng.normal(size=(2, 4, 8, 24))).astype(np.float32)
    x = rng.normal(size=(2, 4, 8, 40)).astype(np.float32)
    jm = jupd.ConvGRU(24)
    v = random_variables(jm, jnp.asarray(h), jnp.asarray(x))
    tm = update.ConvGRU(24, 40)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    _check_grads(jm.apply, v, tm, [h, x])


@pytest.mark.parametrize("out", ["net", "delta"])
def test_small_update_block_matches_flax(rng, out):
    """``SmallUpdateBlock`` (``SmallMotionEncoder``, ``ConvGRU(96)``,
    ``FlowHead(128)``): each output with its gradients; no mask."""
    n = lambda c, s=1.0: rng.normal(0, s, (1, 4, 8, c)).astype(np.float32)
    xs = [np.tanh(n(96)), n(64), n(324), n(2, 3.0)]
    jm = jupd.SmallUpdateBlock(96)
    v = random_variables(jm, *(jnp.asarray(a) for a in xs))
    tm = update.SmallUpdateBlock(96)
    tm.load_state_dict(state_dict_from_jax(v), strict=True)
    i = 0 if out == "net" else 2
    assert tm(*(_nchw(a) for a in xs))[1] is None
    tfn = lambda *a: tm(*a)[i]
    tfn.named_parameters = tm.named_parameters
    _check_grads(lambda vv, *a: jm.apply(vv, *a)[i], v, tfn, xs)


# -- RAFT ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["basic", "small"])
def raft(request):
    """One jitted JAX training-mode apply per variant at 64x128, 2 iterations,
    ``precision="highest"``: the stacked predictions, whose last is the
    test-mode flow (``RAFT._forward`` returns ``preds[-1]``)."""
    jm = JaxRAFT(small=request.param, precision="highest")
    img = jnp.zeros((1, H, W, 3))
    variables = random_variables(jm, img, img, iters=1)
    rng = np.random.default_rng(5)
    i1, i2 = (rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32)
              for _ in range(2))
    # jitted: one compile (~2 s here) instead of op-by-op dispatch (~8 s)
    preds = np.asarray(jax.jit(lambda v, a, b: jm.apply(v, a, b, iters=ITERS))(
        variables, jnp.asarray(i1), jnp.asarray(i2)))
    return request.param, variables, (i1, i2), preds


def _max_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_raft_matches_jax(raft):
    """The port's stacked training predictions (differentiable) and its
    test-mode flow within ``FLOW_TOL`` of max|flow| of JAX's."""
    small, variables, (i1, i2), preds = raft
    model = build_raft("cpu", small=small, precision="highest",
                       state_dict=state_dict_from_jax(variables))
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    train = model(t1, t2, iters=ITERS, test_mode=False)
    assert train.shape == preds.shape == (ITERS, 1, H, W, 2)
    assert train.requires_grad
    err = _max_err(train.detach().numpy(), preds)
    test = model(t1, t2, iters=ITERS)
    err_test = _max_err(test.numpy(), preds[-1])
    print(f"RAFT small={small}: max err / max|flow| {err:.2e} (train), "
          f"{err_test:.2e} (test mode)")
    assert err <= FLOW_TOL and err_test <= FLOW_TOL


def test_raft_strict_load_of_jax_export(raft):
    """JAX's ``export_state_dict`` of each variant loads strictly, and the
    upstream ``raft-things`` names of JAX's ``tests/test_raft.py`` are the
    basic model's."""
    small, variables, _, _ = raft
    sd = strip_module_prefix({k: torch.from_numpy(np.array(v)) for k, v in
                              export_state_dict(variables).items()})
    model = RAFT(small=small)
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    if not small:
        for key in ("fnet.conv1.weight", "cnet.layer2.0.downsample.0.weight",
                    "update_block.encoder.convc1.weight",
                    "update_block.mask.2.bias",
                    "update_block.gru.convz1.weight",
                    "cnet.layer2.0.downsample.1.running_var"):
            assert key in sd
    else:
        assert "update_block.gru.convz.weight" in sd


def test_prior_raft_bn_running_average_field():
    """``PriOrRAFT(bn_running_average=False)``: the context encoder's norms
    take batch statistics (and update their running ones at every call,
    test mode too), the feature encoder keeps its instance norms; the
    default freezes them. ``build_raft`` refuses a missing card."""
    frozen = build_model("cpu", seed=4)
    model = build_model("cpu", seed=4, bn_running_average=False)
    kinds = lambda m: {type(x) for x in m.modules()}
    assert layers.BatchNorm in kinds(model.cnet)
    assert layers.BatchNorm not in kinds(frozen.cnet) | kinds(model.fnet)
    img = torch.rand(1, 32, 64, 3) * 255
    before = model.cnet.norm1.running_mean.clone()
    flow = model(img, img, iters=1)
    assert not torch.equal(model.cnet.norm1.running_mean, before)
    assert torch.isfinite(flow).all()
    assert not torch.allclose(flow, frozen(img, img, iters=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_raft()
