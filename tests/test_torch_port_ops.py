"""Port ops (samplers, warps, static resample, correlation, plain DCCL)
against the JAX package on the CPU. Inputs come from numpy seeds and go
through both implementations."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.ops import corr as jcorr
from prior_flow_tpu.ops import samplers as jsamp
from prior_flow_tpu.ops import static_resample as jstatic
from prior_flow_tpu.ops import warp as jwarp
from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.ops import corr, samplers, static_resample, warp
from prior_flow_tpu_torch.ops.kernels import dccl_lookup

T = torch.from_numpy
SAMPLER_ATOL = 1e-5   # f32 bilinear blends of O(1) payloads
DCCL_ATOL = 5e-5      # the bound tests/test_corr.py uses for DCCL paths


def _coords(rng, B, Q, H, W):
    """Random pixel coords plus the edge cases the samplers treat apart:
    the seam column (W-1, W), negative x, x a hair below 0 (wraps to
    exactly W in f32), x beyond W, and y outside [0, H-1]."""
    x = rng.uniform(-2 * W, 2 * W, (B, Q)).astype(np.float32)
    y = rng.uniform(-2.0, H + 1.0, (B, Q)).astype(np.float32)
    edge_x = [W - 1, W - 0.5, W - 0.01, -0.5, -1e-8, -W - 0.25, 3 * W + 0.3,
              0.0, 0.5, W - 1.5]
    edge_y = [0.0, -0.5, H - 1, H - 0.5, -1.0, H, 0.25, H - 1.25, -3.0, 2.5]
    n = len(edge_x)
    x[:, :n] = edge_x
    y[:, :n] = edge_y
    return np.stack([x, y], axis=-1)


@pytest.mark.parametrize("family", ["bilinear", "cycle_bilinear"])
def test_bilinear_samplers(rng, family):
    B, H, W, C = 2, 6, 10, 3
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    coords = _coords(rng, B, 64, H, W).reshape(B, 8, 8, 2)
    jf = getattr(jsamp, f"{family}_sample")
    tf = getattr(samplers, f"{family}_sample")
    ref = np.asarray(jf(jnp.asarray(img), jnp.asarray(coords)))
    got = tf(T(img), T(coords)).numpy()
    assert got.shape == ref.shape == (B, 8, 8, C)
    np.testing.assert_allclose(got, ref, atol=SAMPLER_ATOL, rtol=0)


def test_cycle_bilinear_seam_quirk():
    """x in (W-1, W) blends toward zero; an x that wraps to exactly W
    samples zero (the samplers mask the corner at column W)."""
    img = np.ones((1, 2, 4, 1), np.float32)
    coords = np.array([[[3.5, 0.0], [-1e-8, 0.0], [0.0, 0.0]]], np.float32)
    got = samplers.cycle_bilinear_sample(T(img), T(coords)).numpy()[0, :, 0]
    np.testing.assert_allclose(got, [0.5, 0.0, 1.0], atol=0)
    assert np.float32(-1e-8) % np.float32(4) == 4.0


@pytest.mark.parametrize("is_grid", [False, True])
def test_cycle_grid_sample(rng, is_grid):
    H, W = 8, 16
    if is_grid:
        img = np.broadcast_to(jgrids.rotation_grids(64, 128).a2b_w2c_8,
                              (2, H, W, 2)).copy()
    else:
        img = rng.normal(size=(2, H, W, 5)).astype(np.float32)
    coords = _coords(rng, 2, 80, H, W)
    ref = np.asarray(jsamp.cycle_grid_sample(jnp.asarray(img),
                                             jnp.asarray(coords),
                                             is_grid=is_grid))
    got = samplers.cycle_grid_sample(T(img), T(coords), is_grid=is_grid).numpy()
    np.testing.assert_allclose(got, ref, atol=SAMPLER_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["cycle_bilinear", "cycle_grid"])
def test_resample_static(rng, mode):
    g = jgrids.rotation_grids(64, 128).b2a_8
    img = rng.normal(size=(2, 8, 16, 7)).astype(np.float32)
    ref = np.asarray(jstatic.resample_static(jnp.asarray(img), g, mode=mode))
    got = static_resample.resample_static(T(img), T(g), mode=mode).numpy()
    np.testing.assert_allclose(got, ref, atol=SAMPLER_ATOL, rtol=0)


def test_img_rotate(rng):
    g = jgrids.rotation_grids(64, 128).a2b
    img = rng.uniform(-1, 1, (2, 64, 128, 6)).astype(np.float32)
    ref = np.asarray(jwarp.img_rotate(jnp.asarray(img), g))
    got = warp.img_rotate(T(img), T(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=SAMPLER_ATOL, rtol=0)


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_flo_rotate(rng, direction):
    g = jgrids.rotation_grids(64, 128)
    w2c, c2w = getattr(g, f"{direction}_w2c_8"), getattr(g, f"{direction}_8")
    flow = rng.normal(0, 2.0, (2, 8, 16, 2)).astype(np.float32)
    ref = np.asarray(jwarp.flo_rotate(jnp.asarray(flow), w2c, c2w))
    got = warp.flo_rotate(T(flow), T(w2c), T(c2w)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_volume_pyramid_groupwise(rng):
    B, h, w, C = 2, 8, 16, 32
    f1 = rng.normal(size=(B, h, w, C)).astype(np.float32)
    f2 = rng.normal(size=(B, h, w, C)).astype(np.float32)
    import jax
    with jax.default_matmul_precision("highest"):
        jvol = jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
        jpyr = jcorr.build_pyramid(jvol, 4)
    vol = corr.all_pairs_correlation(T(f1), T(f2))
    pyr = corr.build_pyramid(vol, 4)
    assert [tuple(p.shape) for p in pyr] == [p.shape for p in jpyr]
    for p, jp in zip(pyr, jpyr):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    odd = rng.normal(size=(1, 3, 7, 9)).astype(np.float32)
    np.testing.assert_allclose(corr.avg_pool2(T(odd)).numpy(),
                               np.asarray(jcorr.avg_pool2(jnp.asarray(odd))),
                               atol=1e-6)
    np.testing.assert_allclose(
        corr.groupwise_corr(T(f1), T(f2), 4).numpy(),
        np.asarray(jcorr.groupwise_corr(jnp.asarray(f1), jnp.asarray(f2), 4)),
        atol=1e-6)


def test_window_delta_matches_reference_order():
    np.testing.assert_array_equal(corr.window_delta(4).numpy(),
                                  jcorr._window_delta(4))


def _dccl_inputs(rng, B=2, h=8, w=16, C=16):
    f = [rng.normal(size=(B, h, w, C)).astype(np.float32) for _ in range(4)]
    pyr_A = corr.build_pyramid(corr.all_pairs_correlation(T(f[0]), T(f[1])))
    pyr_B = corr.build_pyramid(corr.all_pairs_correlation(T(f[2]), T(f[3])))
    base = np.broadcast_to(jgrids.identity_grid(h, w), (B, h, w, 2))
    cA = (base + rng.uniform(-6, 6, (B, h, w, 2))).astype(np.float32)
    cB = (base + rng.uniform(-6, 6, (B, h, w, 2))).astype(np.float32)
    # seam columns, a hair below 0 and the pole rows
    cA[0, 0, :4, 0] = [w - 1, w - 0.5, -1e-8, -0.5]
    cA[0, :4, 0, 1] = [0.0, -0.5, h - 1, h - 0.5]
    cB[-1, -1, -3:, 0] = [w - 0.25, -1e-8, 2 * w + 0.5]
    return pyr_A, pyr_B, cA, cB


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_dccl_matches_two_gather_calls(rng, dtype):
    """The both-branch plain DCCL equals two DCCL(lookup_mode='gather')
    calls of the JAX package, for f32 and bf16 storage; the dispatching
    wrapper takes the plain version on the CPU and launches nothing."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    pyr_A = [p.to(dtype) for p in pyr_A]
    pyr_B = [p.to(dtype) for p in pyr_B]
    g = jgrids.rotation_grids(64, 128)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jA = [jnp.asarray(p.float().numpy()).astype(jdt) for p in pyr_A]
    jB = [jnp.asarray(p.float().numpy()).astype(jdt) for p in pyr_B]
    jd = jcorr.DCCL(4, 4, lookup_mode="gather")
    ref = (*jd(jnp.asarray(cA), jA, jB, g.a2b_w2c_8, g.b2a_8),
           *jd(jnp.asarray(cB), jB, jA, g.b2a_w2c_8, g.a2b_8))
    tg = rotation_grids(64, 128).to_device("cpu")
    args = (T(cA), T(cB), pyr_A, pyr_B, tg.a2b_w2c_8, tg.b2a_w2c_8,
            tg.a2b_8, tg.b2a_8)
    plain = corr.DCCLFused(4, 4, level_lookup=corr.dccl_level_lookup_plain)(
        *args)
    before = dccl_lookup.dccl_level_lookup.launches
    dispatched = corr.DCCLFused(4, 4)(*args)
    assert dccl_lookup.dccl_level_lookup.launches == before
    for name, p, d, r in zip(("own_A", "cross_A", "own_B", "cross_B"),
                             plain, dispatched, ref):
        assert p.dtype == torch.float32 and tuple(p.shape) == r.shape
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=DCCL_ATOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_array_equal(p.numpy(), d.numpy())


def test_level_lookup_zero_where_x_wraps_to_width():
    """A tap whose x is a hair below 0 wraps to exactly W in f32 and samples
    zero, as the samplers do; the column W-1 value must not leak in."""
    B, Q, Hl, Wl = 1, 1, 4, 8
    vol = torch.ones(B, Q, Hl, Wl)
    cen = torch.tensor([[[-1e-8, 2.0]]])
    grid = torch.from_numpy(jgrids.identity_grid(Hl, Wl).copy())
    own, _, _, _ = dccl_lookup.dccl_level_lookup_plain(
        vol, vol, cen, cen, grid, grid, 1.0)
    own = own.reshape(9, 9)                 # [i, j]: x-offset i-4, y j-4
    assert torch.all(own[4, 2:5] == 0.0)    # x = W exactly, rows 0..2 valid
    assert torch.all(own[5, 2:5] == 1.0)    # x = 1 - 1e-8 -> interior


@pytest.mark.slow  # interpret-mode Pallas on the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_level_lookup_matches_pallas_interpret(rng, dtype):
    """The plain level lookup against the Pallas grid kernel it stands for,
    away from the x-wraps-to-W edge (where the Pallas kernel clips to
    column W-1 instead of sampling zero)."""
    from prior_flow_tpu.ops.pallas.dccl_gather import \
        dccl_level_lookup_grid_fused
    pyr_A, pyr_B, _, _ = _dccl_inputs(rng)
    g = jgrids.rotation_grids(64, 128)
    base = np.broadcast_to(jgrids.identity_grid(8, 16), (2, 8, 16, 2))
    cA = (base + rng.uniform(-3, 3, base.shape)).astype(np.float32).reshape(
        2, 128, 2)
    cB = (base + rng.uniform(-3, 3, base.shape)).astype(np.float32).reshape(
        2, 128, 2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for lvl in range(4):
        vA, vB = pyr_A[lvl].to(dtype), pyr_B[lvl].to(dtype)
        s = 1.0 / 2 ** lvl
        ref = dccl_level_lookup_grid_fused(
            jnp.asarray(vA.float().numpy()).astype(jdt),
            jnp.asarray(vB.float().numpy()).astype(jdt),
            jnp.asarray(cA), jnp.asarray(cB), jnp.asarray(g.a2b_w2c_8),
            jnp.asarray(g.b2a_w2c_8), s, interpret=True)
        got = dccl_lookup.dccl_level_lookup_plain(
            vA, vB, T(cA), T(cB), T(g.a2b_w2c_8), T(g.b2a_w2c_8), s)
        for r, t in zip(ref, got):
            np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                       atol=DCCL_ATOL, rtol=0)
