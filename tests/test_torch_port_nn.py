"""Port nn blocks and the instance norm against their Flax counterparts on
the CPU, with the same weights: random Flax variables (drawn with numpy)
pushed through ``state_dict_from_jax`` and loaded strictly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prior_flow_tpu.nn import encoder as jenc
from prior_flow_tpu.nn import layers as jlayers
from prior_flow_tpu.nn import update as jupd
from prior_flow_tpu.ops.pallas.instance_norm import instance_norm_fused
from prior_flow_tpu_torch.checkpoint import state_dict_from_jax
from prior_flow_tpu_torch.nn import encoder, update
from prior_flow_tpu_torch.ops.kernels import instance_norm as tin

ATOL = 1e-4  # f32 conv stacks summed in another order, O(1) activations


def random_variables(module, *args, seed=0, **kwargs):
    """Flax variables of ``module`` with numpy-random values: shapes from
    an abstract init (no compile), kernels N(0, 1/fan_in), biases and BN
    statistics away from their defaults so every term is exercised."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(tmod, variables):
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    return tmod.eval()


@pytest.mark.parametrize("C", [64, 96, 128])
def test_instance_norm_matches_pallas_interpret(rng, C):
    """Plain instance norm (NCHW) against the Pallas kernel in interpret
    mode (NHWC), f32 and bf16 input; both normalise in f32."""
    x = (rng.normal(size=(2, 8, 16, C)) * 3.0 + 1.5).astype(np.float32)
    ref = np.asarray(instance_norm_fused(jnp.asarray(x), 1e-5, None, True))
    got = _nhwc(tin.instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref_b = np.asarray(instance_norm_fused(xb, 1e-5, jnp.bfloat16, True),
                       np.float32)
    got_b = tin.instance_norm(_nchw(x).to(torch.bfloat16))
    assert got_b.dtype == torch.bfloat16
    # one bf16 rounding of f32 results that agree to ~1e-6
    np.testing.assert_allclose(_nhwc(got_b.float()), ref_b, rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("C", [64, 128])
def test_instance_norm_vjp_matches_pallas_interpret(rng, C):
    """InstanceNormFunction's backward against jax.vjp of
    instance_norm_fused (the Pallas kernel in interpret mode and its custom
    VJP), f32; on the CPU the sums go through the plain version."""
    x = (rng.normal(size=(2, 8, 16, C)) * 3.0 + 1.5).astype(np.float32)
    dy = rng.normal(size=(2, 8, 16, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: instance_norm_fused(v, 1e-5, None, True),
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    t = _nchw(x).requires_grad_()
    tin.instance_norm(t).backward(_nchw(dy))
    np.testing.assert_allclose(_nhwc(t.grad), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # bf16 activations: the gradient comes back in bf16
    tb = _nchw(x).to(torch.bfloat16).requires_grad_()
    tin.instance_norm(tb).backward(_nchw(dy).to(torch.bfloat16))
    assert tb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(tb.grad.float()), np.asarray(ref),
                               rtol=5e-2, atol=5e-2)


def test_instance_norm_matches_xla_branch(rng):
    """f32 against the XLA InstanceNorm branch, the CPU reference path."""
    x = (rng.normal(size=(2, 16, 32, 64)) * 2.0 - 0.5).astype(np.float32)
    mod = jlayers.InstanceNorm()
    ref = np.asarray(mod.apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(_nhwc(tin.instance_norm(_nchw(x))), ref,
                               rtol=1e-5, atol=1e-5)


def test_instance_norm_sums_contract(rng):
    """sums(x, y) = (sum y, sum x*y) per (sample, channel); the CPU path is
    the plain version and launches nothing."""
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    y = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    before = tin.instance_norm_sums.launches
    s1, s2 = tin.instance_norm_sums(torch.from_numpy(x), torch.from_numpy(y))
    assert tin.instance_norm_sums.launches == before
    np.testing.assert_allclose(s1.numpy(), y.sum(axis=(2, 3)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), (x * y).sum(axis=(2, 3)),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(1, 2, 4, 4, device="meta")
    with pytest.raises(RuntimeError):
        tin.instance_norm_sums(x, x)
    from prior_flow_tpu_torch.ops.kernels.dccl_lookup import (
        dccl_level_lookup, dccl_level_lookup_coords, dccl_lookup_all_levels)
    v = torch.empty(1, 2, 4, 8, device="meta")
    c = torch.empty(1, 2, 2, device="meta")
    g = torch.empty(4, 8, 2, device="meta")
    x = torch.empty(1, 2, 81, device="meta")
    with pytest.raises(RuntimeError):
        dccl_level_lookup(v, v, c, c, g, g, 1.0)
    with pytest.raises(RuntimeError):
        dccl_level_lookup_coords(v, v, c, c, 1.0, x, x, x, x)
    with pytest.raises(RuntimeError):
        dccl_lookup_all_levels([v], [v], c, c, g, g, [1.0])


@pytest.mark.parametrize("norm_fn,stride", [("instance", 1), ("instance", 2),
                                            ("batch", 1), ("batch", 2)])
def test_residual_block(rng, norm_fn, stride):
    cin, cout = (16, 24) if stride == 2 else (24, 24)
    x = rng.normal(size=(2, 8, 16, cin)).astype(np.float32)
    jm = jenc.ResidualBlock(cin, cout, norm_fn, stride=stride)
    v = random_variables(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = _load(encoder.ResidualBlock(cin, cout, norm_fn, stride=stride), v)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("norm_fn,out_dim", [("instance", 256),
                                             ("batch", 256)])
def test_basic_encoder_list_input(rng, norm_fn, out_dim):
    """A list input is batched by concatenation and split back."""
    xs = [rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)
          for _ in range(2)]
    jm = jenc.BasicEncoder(output_dim=out_dim, norm_fn=norm_fn)
    v = random_variables(jm, [jnp.asarray(a) for a in xs])
    with jax.default_matmul_precision("highest"):
        ref = jm.apply(v, [jnp.asarray(a) for a in xs])
    tm = _load(encoder.BasicEncoder(out_dim, norm_fn), v)
    got = tm([_nchw(a) for a in xs])
    assert len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=ATOL, rtol=0)


def test_flow_head_and_gru(rng):
    x = rng.normal(size=(1, 4, 8, 128)).astype(np.float32)
    h = np.tanh(rng.normal(size=(1, 4, 8, 128))).astype(np.float32)
    inp = rng.normal(size=(1, 4, 8, 256)).astype(np.float32)
    jf = jupd.FlowHead(256)
    vf = random_variables(jf, jnp.asarray(x))
    tf = _load(update.FlowHead(128, 256), vf)
    np.testing.assert_allclose(_nhwc(tf(_nchw(x))),
                               np.asarray(jf.apply(vf, jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    jg = jupd.SepConvGRU(128)
    vg = random_variables(jg, jnp.asarray(h), jnp.asarray(inp))
    tg = _load(update.SepConvGRU(128, 256), vg)
    np.testing.assert_allclose(
        _nhwc(tg(_nchw(h), _nchw(inp))),
        np.asarray(jg.apply(vg, jnp.asarray(h), jnp.asarray(inp))),
        atol=ATOL, rtol=0)


def _update_inputs(rng, B=1, h=4, w=8):
    n = lambda c, s=1.0: rng.normal(0, s, (B, h, w, c)).astype(np.float32)
    return dict(net=np.tanh(n(128)), inp=n(128), corr=n(324), flow=n(2, 3.0),
                flaw_A=n(4), flow_B_A=n(2, 3.0), flaw_B_A=n(4))


def test_motion_encoders(rng):
    a = _update_inputs(rng)
    j = jupd.BasicMotionEncoder()
    v = random_variables(j, jnp.asarray(a["flow"]), jnp.asarray(a["corr"]))
    t = _load(update.BasicMotionEncoder(), v)
    np.testing.assert_allclose(
        _nhwc(t(_nchw(a["flow"]), _nchw(a["corr"]))),
        np.asarray(j.apply(v, jnp.asarray(a["flow"]), jnp.asarray(a["corr"]))),
        atol=ATOL, rtol=0)
    keys = ("flow", "corr", "flaw_A", "flow_B_A", "flaw_B_A")
    jm = jupd.BasicMultiMotionEncoder()
    vm = random_variables(jm, *(jnp.asarray(a[k]) for k in keys))
    tm = _load(update.BasicMultiMotionEncoder(), vm)
    np.testing.assert_allclose(
        _nhwc(tm(*(_nchw(a[k]) for k in keys))),
        np.asarray(jm.apply(vm, *(jnp.asarray(a[k]) for k in keys))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("block", ["BasicUpdateBlock", "BasicMultiUpdateBlock"])
def test_update_blocks(rng, block):
    a = _update_inputs(rng)
    if block == "BasicUpdateBlock":
        keys = ("net", "inp", "corr", "flow")
    else:
        keys = ("net", "inp", "flow", "corr", "flaw_A", "flow_B_A", "flaw_B_A")
    jm = getattr(jupd, block)(128)
    v = random_variables(jm, *(jnp.asarray(a[k]) for k in keys))
    r_net, r_mask, r_delta = jm.apply(v, *(jnp.asarray(a[k]) for k in keys))
    tm = _load(getattr(update, block)(128), v)
    t_net, t_mask, t_delta = tm(*(_nchw(a[k]) for k in keys))
    for t, r in ((t_net, r_net), (t_mask, r_mask), (t_delta, r_delta)):
        np.testing.assert_allclose(_nhwc(t), np.asarray(r), atol=ATOL, rtol=0)
    _, no_mask, _ = tm(*(_nchw(a[k]) for k in keys), with_mask=False)
    assert no_mask is None
