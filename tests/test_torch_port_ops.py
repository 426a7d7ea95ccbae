"""Port ops (samplers, warps, static resample, correlation, plain DCCL, and
the backward pieces: sampler VJPs, the resample transpose, the DCCL cross
tap coords and volume scatter; the chunked pyramid build, the lookup at
given cross coords, and the planes and all-levels DCCL routes) against the
JAX package on the CPU. Inputs come from numpy seeds and go through both
implementations."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.ops import corr as jcorr
from prior_flow_tpu.ops import samplers as jsamp
from prior_flow_tpu.ops import static_resample as jstatic
from prior_flow_tpu.ops import warp as jwarp
from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.ops import corr, samplers, static_resample, warp
from prior_flow_tpu_torch.ops.kernels import (dccl_coords, dccl_lookup,
                                              dccl_scatter)

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


# -- backward contracts: samplers, static resample, DCCL coords and scatter --

def test_samplers_vjp_match_jax(rng):
    """Image VJPs of the three samplers (the flaw-map warps and the
    back-rotations) against jax.vjp, on seam and edge coords."""
    B, H, W, C = 2, 6, 10, 3
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    coords = _coords(rng, B, 64, H, W).reshape(B, 8, 8, 2)
    ct = rng.normal(size=(B, 8, 8, C)).astype(np.float32)
    for name in ("bilinear_sample", "cycle_bilinear_sample",
                 "cycle_grid_sample"):
        _, vjp = jax.vjp(lambda i: getattr(jsamp, name)(i, jnp.asarray(coords)),
                         jnp.asarray(img))
        (ref,) = vjp(jnp.asarray(ct))
        t = T(img).requires_grad_()
        getattr(samplers, name)(t, T(coords)).backward(T(ct))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=SAMPLER_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["cycle_bilinear", "cycle_grid"])
def test_resample_static_vjp_and_transpose_match_jax(rng, mode):
    g = jgrids.rotation_grids(64, 128).b2a_8
    img = rng.normal(size=(3, 8, 16, 5)).astype(np.float32)
    ct = rng.normal(size=(3, 8, 16, 5)).astype(np.float32)
    _, vjp = jax.vjp(lambda i: jstatic.resample_static(i, g, mode=mode),
                     jnp.asarray(img))
    (ref,) = vjp(jnp.asarray(ct))
    t = T(img).requires_grad_()
    static_resample.resample_static(t, T(g), mode=mode).backward(T(ct))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                               atol=SAMPLER_ATOL, rtol=0)
    plan = jstatic.transpose_plan(g, (8, 16), mode=mode)
    ref_t = np.asarray(jstatic.apply_transpose(plan, jnp.asarray(ct)))
    got_t = static_resample.resample_static_transpose(T(ct), T(g), (8, 16),
                                                      mode=mode)
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=SAMPLER_ATOL, rtol=0)


def test_empty_plane_samples_zero():
    """The 1/64 pyramid level of a 32-pixel-high input has no rows: JAX
    samples zero there, and so does the port (it raised before)."""
    img = np.zeros((2, 0, 1, 3), np.float32)
    coords = np.array([[[0.5, 0.0], [0.0, -0.5]]] * 2, np.float32)
    ref = np.asarray(jsamp.cycle_bilinear_sample(jnp.asarray(img),
                                                 jnp.asarray(coords)))
    got = samplers.cycle_bilinear_sample(T(img), T(coords))
    assert got.shape == ref.shape == (2, 2, 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def _centres(rng, N, h, w):
    """Unscaled 1/8 centres over the image and a margin, with the seam and
    the pole rows. No x a hair below 0: there an x wraps to exactly W, where
    the Pallas grid window takes column 0 and the samplers give zero
    (ROADMAP Queue 3)."""
    c = np.stack([rng.uniform(-2, w + 2, N), rng.uniform(-2, h + 2, N)],
                 -1).astype(np.float32)
    c[:6] = [[w - 1, 0.0], [w - 0.5, h - 1], [-1e-3, 2.0], [-0.5, -0.5],
             [w - 1e-3, h - 0.5], [0.0, h - 1.0]]
    return c


def _coords_vs_pallas(rng, H, W, N, atol=1e-5):
    """Both coords entries' plain versions at every level against the Pallas
    coords kernel in interpret mode: the one-branch ``dccl_grid_coords``
    and, level by level, the both-branch all-levels ``dccl_cross_coords``
    (branch B at other centres); the wrappers launch nothing on the CPU."""
    from prior_flow_tpu.ops.pallas.dccl_gather import (dccl_grid_coords,
                                                       pack_grid_planes)
    g = jgrids.rotation_grids(H, W)
    cens = (_centres(rng, N, H // 8, W // 8), _centres(rng, N, H // 8, W // 8))
    grids = (g.a2b_w2c_8, g.b2a_w2c_8)
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    n0 = dccl_coords.dccl_cross_coords.launches
    planes = dccl_coords.dccl_cross_coords(
        *(T(c).reshape(1, N, 2) for c in cens), *(T(g) for g in grids),
        scales)
    assert dccl_coords.dccl_cross_coords.launches == n0
    assert all(p.shape == (4 * N, 81) for p in planes)
    for br, (cen, grid) in enumerate(zip(cens, grids)):
        for lvl, s in enumerate(scales):
            rx, ry = dccl_grid_coords(jnp.asarray(cen),
                                      pack_grid_planes(jnp.asarray(grid)),
                                      grid.shape[1], s, interpret=True)
            cx, cy = dccl_coords.dccl_grid_coords_plain(T(cen), T(grid), s)
            rows = slice(lvl * N, (lvl + 1) * N)
            assert cx.shape == cy.shape == (N, 81)
            for got, ref in ((cx, rx), (cy, ry),
                             (planes[2 * br][rows], rx),
                             (planes[2 * br + 1][rows], ry)):
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(ref)[:, :81],
                                           atol=atol, rtol=0)


def test_grid_coords_plain_matches_pallas_interpret(rng):
    """The plain cross tap coords against the Pallas coords kernel
    (interpret mode), atol 1e-5 px, 64x128-class grid, all four levels."""
    _coords_vs_pallas(rng, 64, 128, 64)


@pytest.mark.slow  # interpret-mode Pallas over a 512x1024-class grid
def test_grid_coords_plain_matches_pallas_interpret_full_grid(rng):
    """At a 64x128 grid the coords reach 128 px and neighbouring grid cells
    differ by up to 32 px. The Pallas window takes the fraction of the
    scaled centre once and adds the integer offsets after; the port (like
    its lookup, which it must match bit for bit) adds them first. The two
    f32 orders then place a tap up to 2 ulps apart (1.5e-5 px each at
    128), which the grid's slope turns into up to 2 x 1.5e-5 x 32 = 9.8e-4
    px: this grid is held to 1e-3 px (measured: 4.4e-4)."""
    _coords_vs_pallas(rng, 512, 1024, 512, atol=1e-3)


@pytest.mark.parametrize("batch", [1, 3])
def test_cross_coords_plain_is_the_stacked_per_level_coords(rng, batch):
    """The both-branch all-levels coords (the planes route's call) are
    bitwise the per-level ``dccl_grid_coords_plain`` of each branch,
    stacked level after level, on the 128x256 grids of a 1024x2048 input
    with the seam, a hair below 0 and the pole rows among the centres."""
    h, w, Q = 128, 256, 40
    g = rotation_grids(8 * h, 8 * w).to_device("cpu")
    grids = (g.a2b_w2c_8, g.b2a_w2c_8)
    cens = [T(_centres(rng, batch * Q, h, w)).reshape(batch, Q, 2)
            for _ in range(2)]
    cens[1][0, 6:9] = torch.tensor([[-1e-8, 5.0], [w - 1e-3, 0.0],
                                    [0.5, h - 1.0]])
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    planes = dccl_coords.dccl_cross_coords_plain(*cens, *grids, scales)
    for br, (cen, grid) in enumerate(zip(cens, grids)):
        for j in (0, 1):
            want = torch.cat([dccl_coords.dccl_grid_coords_plain(
                cen.reshape(-1, 2), grid, s)[j] for s in scales])
            assert torch.equal(planes[2 * br + j], want)


def test_grid_coords_plain_is_the_lookups_cross_coords(rng):
    """The plain coords are exactly the coords at which the plain lookup
    samples the other volume: cross_A equals sampling volume B there."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    cqA = T(cA).reshape(2, 128, 2)
    cqB = T(cB).reshape(2, 128, 2)
    for lvl in range(4):
        s = 1.0 / 2 ** lvl
        _, cross_A, _, _ = dccl_lookup.dccl_level_lookup_plain(
            pyr_A[lvl], pyr_B[lvl], cqA, cqB, g.a2b_w2c_8, g.b2a_w2c_8, s)
        cx, cy = dccl_coords.dccl_grid_coords(cqA.reshape(-1, 2), g.a2b_w2c_8,
                                              s)
        at = torch.stack([cx, cy], -1).reshape(2, 128, 81, 2)
        ref = dccl_lookup.sample_volume_level(pyr_B[lvl], at)
        np.testing.assert_array_equal(cross_A.numpy(), ref.numpy())


def _scatter_inputs(rng, S, B, Q, Hl, Wl, away_from_edge=True):
    g_own = rng.normal(size=(S, B, Q, 81)).astype(np.float32)
    g_cross = rng.normal(size=(S, B, Q, 81)).astype(np.float32)
    cen = np.stack([rng.uniform(-3, 2 * Wl + 3, (S, B, Q)),
                    rng.uniform(-3, 2 * Hl + 3, (S, B, Q))], -1
                   ).astype(np.float32)
    cx = rng.uniform(-Wl, 2 * Wl, (S, B, Q, 81)).astype(np.float32)
    cy = rng.uniform(-2, Hl + 1, (S, B, Q, 81)).astype(np.float32)
    if not away_from_edge:
        cx[0, 0, 0, :3] = [-1e-8, Wl - 1, Wl - 0.5]
        cen[0, 0, 0] = [-1e-8, 1.0]
    return g_own, cen, g_cross, cx, cy


@pytest.mark.parametrize("S", [1, 3])
def test_level_scatter_plain_matches_jax_einsums(rng, S):
    """The plain scatter against the JAX backward's one-hot einsums:
    _scatter_own_cross for S = 1, _scatter_grads_window_multi +
    _scatter_grads_multi for S = 3, away from the x == W edge (where JAX
    clips to column W-1, ROADMAP Queue 3)."""
    from prior_flow_tpu.ops.pallas import dccl_gather as jdg
    B, Q, Hl, Wl, scale = 2, 6, 8, 16, 0.5
    g_own, cen, g_cross, cx, cy = _scatter_inputs(rng, S, B, Q, Hl, Wl)
    j = jnp.asarray
    if S == 1:
        ref = jdg._scatter_own_cross(j(g_own[0]), j(cen[0]), scale,
                                     j(g_cross[0]), j(cx[0]), j(cy[0]), Hl, Wl,
                                     jnp.float32)
    else:
        ref = (jdg._scatter_grads_window_multi(j(g_own), j(cen), scale, Hl, Wl,
                                               jnp.float32)
               + jdg._scatter_grads_multi(j(g_cross), j(cx), j(cy), Hl, Wl,
                                          jnp.float32))
    got = dccl_scatter.dccl_level_scatter(T(g_own), T(cen), scale, T(g_cross),
                                          T(cx), T(cy), Hl, Wl)
    assert got.shape == (B, Q, Hl, Wl) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_level_scatter_is_the_exact_transpose_of_the_lookup(rng):
    """The scatter of the lookup's cotangents (volume A: branch A's own
    taps and branch B's cross taps) equals torch.autograd of the plain
    lookup, with the x == W edge included; S = 2 is the sum of two S = 1
    scatters; bf16 output is the f32 result rounded once."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    cqA = T(cA).reshape(2, 128, 2)
    cqB = T(cB).reshape(2, 128, 2)
    for lvl in (0, 2):
        s = 1.0 / 2 ** lvl
        vA = pyr_A[lvl].clone().requires_grad_()
        vB = pyr_B[lvl].clone().requires_grad_()
        outs = dccl_lookup.dccl_level_lookup_plain(vA, vB, cqA, cqB,
                                                   g.a2b_w2c_8, g.b2a_w2c_8, s)
        cts = [T(rng.normal(size=(2, 128, 81)).astype(np.float32))
               for _ in range(4)]
        dA, dB = torch.autograd.grad(outs, (vA, vB), cts)
        cxB, cyB = dccl_coords.dccl_grid_coords(cqB.reshape(-1, 2),
                                                g.b2a_w2c_8, s)
        one = lambda t: t.reshape(1, 2, 128, -1)
        Hl, Wl = vA.shape[2:]
        got = dccl_scatter.dccl_level_scatter(one(cts[0]), one(cqA), s,
                                              one(cts[3]), one(cxB), one(cyB),
                                              Hl, Wl)
        np.testing.assert_allclose(got.numpy(), dA.numpy(), atol=1e-6,
                                   rtol=1e-6)
    g_own, cen, g_cross, cx, cy = (T(a) for a in _scatter_inputs(
        rng, 2, 2, 5, 4, 8, away_from_edge=False))
    two = dccl_scatter.dccl_level_scatter(g_own, cen, 0.5, g_cross, cx, cy, 4, 8)
    parts = [dccl_scatter.dccl_level_scatter(g_own[i:i + 1], cen[i:i + 1], 0.5,
                                             g_cross[i:i + 1], cx[i:i + 1],
                                             cy[i:i + 1], 4, 8)
             for i in range(2)]
    np.testing.assert_allclose(two.numpy(), (parts[0] + parts[1]).numpy(),
                               atol=1e-5, rtol=1e-6)
    bf = dccl_scatter.dccl_level_scatter(g_own, cen, 0.5, g_cross, cx, cy, 4, 8,
                                         torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, two.to(torch.bfloat16))


def test_scatter_zero_where_x_wraps_to_width():
    """A tap whose x wraps to exactly W got zero in the forward, so it
    scatters nothing; the JAX backward would put it into column W-1."""
    S, B, Q, Hl, Wl = 1, 1, 1, 4, 8
    g = torch.zeros(S, B, Q, 81)
    g[0, 0, 0, 0] = 1.0
    cx = torch.zeros(S, B, Q, 81)
    cy = torch.full((S, B, Q, 81), 1.0)
    cx[0, 0, 0, 0] = -1e-8
    far = torch.full((S, B, Q, 2), 100.0)   # own window entirely outside
    out = dccl_scatter.dccl_level_scatter(torch.zeros_like(g), far, 1.0, g,
                                          cx, cy, Hl, Wl)
    assert float(out.abs().sum()) == 0.0


def test_dccl_fused_gradient_matches_autograd_of_plain(rng):
    """DCCLFused's default route (``DCCLAllLevelsLookup``, whose backward
    runs the grid-entry scatter wrapper: its plain version on the CPU)
    gives the volumes the same gradient as autograd of the plain gathers
    injected through ``level_lookup``. With bf16 pyramids the Function
    accumulates in f32 and rounds once, so it is held to the f32 gradient
    of the same (bf16-valued) volumes within half a bf16 step."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    cts = [T(rng.normal(size=(2, 8, 16, 324)).astype(np.float32))
           for _ in range(4)]

    def grads(lookup, dtype):
        vA = [p.detach().to(dtype).clone().requires_grad_() for p in pyr_A]
        vB = [p.detach().to(dtype).clone().requires_grad_() for p in pyr_B]
        outs = corr.DCCLFused(4, 4, level_lookup=lookup, fuse_levels=False)(
            T(cA), T(cB), vA, vB, g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8, g.b2a_8)
        torch.autograd.backward(outs, cts)
        return [v.grad for v in vA + vB]

    for a, b in zip(grads(None, torch.float32),
                    grads(corr.dccl_level_lookup_plain, torch.float32)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    pyr_A = [p.to(torch.bfloat16).float() for p in pyr_A]
    pyr_B = [p.to(torch.bfloat16).float() for p in pyr_B]
    for a, b in zip(grads(None, torch.bfloat16),
                    grads(corr.dccl_level_lookup_plain, torch.float32)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   rtol=2.0 ** -8, atol=1e-6)


def test_record_gives_the_summed_fields(rng):
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    args = (T(cA), T(cB), pyr_A, pyr_B, g.a2b_w2c_8, g.b2a_w2c_8, g.a2b_8,
            g.b2a_8)
    own_A, cross_A, own_B, cross_B = corr.DCCLFused(4, 4)(*args)
    (f_A, f_B), (cen_A, cen_B) = corr.DCCLFused(4, 4).record(*args)
    assert torch.equal(f_A, own_A + cross_A) and torch.equal(f_B, own_B + cross_B)
    assert torch.equal(cen_A, T(cA).reshape(2, 128, 2))
    assert not f_A.requires_grad


# -- the 1024x2048 path: chunked pyramid build, lookup at given cross coords,
# -- the planes and all-levels routes --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_pyramid_lean_matches_jax_and_dense(rng, dtype):
    """The chunked build against JAX's ``build_pyramid_lean`` (B = 2, 8x16,
    C = 32, q_chunk 32): f32 to 1e-5, bf16 to one bf16 step of the value;
    and bitwise equal to the port's dense build cast level by level."""
    B, h, w, C = 2, 8, 16, 32
    f1 = rng.normal(size=(B, h, w, C)).astype(np.float32)
    f2 = rng.normal(size=(B, h, w, C)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with jax.default_matmul_precision("highest"):
        ref = jcorr.build_pyramid_lean(jnp.asarray(f1), jnp.asarray(f2), 4,
                                       jdt, q_chunk=32)
    lean = corr.build_pyramid_lean(T(f1), T(f2), 4, dtype, q_chunk=32)
    dense = corr.build_pyramid(corr.all_pairs_correlation(T(f1), T(f2)), 4)
    assert [tuple(p.shape) for p in lean] == [r.shape for r in ref]
    for p, r, d in zip(lean, ref, dense):
        assert p.dtype == dtype
        r = np.asarray(r.astype(jnp.float32))
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * np.abs(r) + 1e-6
        assert np.all(np.abs(p.float().numpy() - r) <= tol)
        assert torch.equal(p, d.to(dtype))
    with pytest.raises(AssertionError):
        corr.build_pyramid_lean(T(f1), T(f2), 4, dtype, q_chunk=48)


@pytest.mark.parametrize("size", [(512, 1024), (1024, 2048)])
def test_planes_coords_match_jax_window_planes(rng, size):
    """The planes route's cross tap coords (all four level scales in one
    coords call) against JAX's ``sample_image_window_planes`` on the 1/8
    grids of a 512x1024 (64x128) and a 1024x2048 (128x256) input.

    Both compute the grid sampled at the window around cen * scale, in
    two f32 orders: JAX takes the fraction of the wrapped centre and adds
    the integer offsets after, the port (bit for bit the lookup kernel's
    own) wraps centre + offset. Where the cell's four corners (zero beyond
    the last column, the seam quirk) span less than 8 px the two agree
    within 1e-4 px (measured 4.6e-5 at 128x256). A window that wraps to
    just below W takes its fraction at W's f32 spacing, and next to the
    seam a corner spread of up to ~W turns that into up to 1.7e-3 px
    (measured at 128x256): every tap is held to 1e-4 px plus two f32
    spacings of its coordinate times its cell's corner spread."""
    H, W = size
    h, w = H // 8, W // 8
    N = 256
    cen = _centres(rng, N, h, w)
    scales = [1.0 / 2 ** i for i in range(4)]
    g = rotation_grids(H, W).to_device("cpu")
    delta = corr.window_delta(4).numpy()
    c = T(cen).reshape(1, N, 2)
    planes = dccl_coords.dccl_cross_coords(c, c, g.a2b_w2c_8, g.b2a_w2c_8,
                                           scales)
    for grid, cx, cy in ((g.a2b_w2c_8, *planes[:2]),
                         (g.b2a_w2c_8, *planes[2:])):
        assert cx.shape == cy.shape == (4 * N, 81)
        gn = grid.numpy()
        for lvl, s in enumerate(scales):
            with jax.default_matmul_precision("highest"):
                rx, ry = jcorr.sample_image_window_planes(
                    jnp.asarray(gn[None, ..., 0]), jnp.asarray(gn[None, ..., 1]),
                    jnp.asarray(cen[None] * np.float32(s)), 4)
            rows = slice(lvl * N, (lvl + 1) * N)
            err = np.maximum(np.abs(cx[rows].numpy() - np.asarray(rx)[0]),
                             np.abs(cy[rows].numpy() - np.asarray(ry)[0]))
            win = (cen * np.float32(s))[:, None, :] + delta
            x = np.mod(win[..., 0], np.float32(w))
            y = win[..., 1]
            x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
            corners = []
            for dy in (0, 1):
                for dx in (0, 1):
                    ix, iy = x0 + dx, y0 + dy
                    ok = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
                    corners.append(gn[np.clip(iy, 0, h - 1),
                                      np.clip(ix, 0, w - 1)] * ok[..., None])
            corners = np.stack(corners)
            spread = (corners.max(0) - corners.min(0)).max(-1)
            mag = np.maximum(np.maximum(x, np.abs(y)), 1.0).astype(np.float32)
            assert np.all(err <= 1e-4 + 2 * np.spacing(mag) * spread)
            assert np.all(err[spread < 8] <= 1e-4)


def test_lookup_at_given_coords_matches_jax_gathers(rng):
    """The plain lookup at given cross coords against the gathers of JAX's
    ``DCCL(lookup_mode='gather')`` (``sample_volume_level``) at the same
    own window and the same cross coords, f32 and bf16 volumes, all four
    levels, at DCCL_ATOL; the wrapper takes the plain version on the CPU
    and launches nothing."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    cqA, cqB = cA.reshape(2, 128, 2), cB.reshape(2, 128, 2)
    delta = jcorr._window_delta(4)[None, None]
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        for lvl in range(4):
            vA, vB = pyr_A[lvl].to(dtype), pyr_B[lvl].to(dtype)
            Hl, Wl = vA.shape[2:]
            s = 1.0 / 2 ** lvl
            given = []
            for _ in range(2):
                c = _coords(rng, 2, 128 * 81, Hl, Wl).reshape(2, 128, 81, 2)
                given += [c[..., 0], c[..., 1]]
            jA = jnp.asarray(vA.float().numpy()).astype(jdt)
            jB = jnp.asarray(vB.float().numpy()).astype(jdt)
            ref = []
            for own, other, cq, (gx, gy) in ((jA, jB, cqA, given[:2]),
                                             (jB, jA, cqB, given[2:])):
                ref.append(jcorr.sample_volume_level(
                    own, jnp.asarray(cq * s)[:, :, None] + delta))
                ref.append(jcorr.sample_volume_level(
                    other, jnp.asarray(np.stack([gx, gy], -1))))
            n0 = dccl_lookup.dccl_level_lookup_coords.launches
            got = dccl_lookup.dccl_level_lookup_coords(
                vA, vB, T(cqA), T(cqB), s, *(T(c) for c in given))
            assert dccl_lookup.dccl_level_lookup_coords.launches == n0
            for t, r in zip(got, ref):
                assert t.dtype == torch.float32 and t.shape == (2, 128, 81)
                np.testing.assert_allclose(t.numpy(),
                                           np.asarray(r.astype(jnp.float32)),
                                           atol=DCCL_ATOL, rtol=0)


@pytest.mark.parametrize("route", ["planes", "fused_levels"])
def test_dccl_routes_are_bitwise_the_grid_route(rng, route):
    """``DCCLFused(grid_in_kernel=False)`` (coords first, then the lookup
    at given coords) and ``DCCLFused(fuse_levels=True)`` (all levels in one
    call) give the default route's bits on the CPU, seam and pole edges
    included, for f32 and bf16 pyramids."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    kw = ({"grid_in_kernel": False} if route == "planes"
          else {"fuse_levels": True})
    for dtype in (torch.float32, torch.bfloat16):
        args = (T(cA), T(cB), [p.to(dtype) for p in pyr_A],
                [p.to(dtype) for p in pyr_B], g.a2b_w2c_8, g.b2a_w2c_8,
                g.a2b_8, g.b2a_8)
        ref = corr.DCCLFused(4, 4)(*args)
        got = corr.DCCLFused(4, 4, **kw)(*args)
        for r, t in zip(ref, got):
            assert torch.equal(r, t)


@pytest.mark.parametrize("fn", ["coords", "all_levels"])
def test_new_lookup_functions_gradient_matches_autograd_of_plain(rng, fn):
    """``DCCLLevelLookupCoords`` (backward: scatters at the saved given
    coords) and ``DCCLAllLevelsLookup`` with all levels in one launch
    (backward: per level, scatters that recompute the coords) give the volumes the gradient autograd
    takes through their plain versions, f32 to 1e-5; bf16 volumes within
    half a bf16 step of the f32 gradient of the same values."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    cqA, cqB = T(cA).reshape(2, 128, 2), T(cB).reshape(2, 128, 2)
    scales = tuple(1.0 / 2 ** i for i in range(4))
    given = [T(_coords(rng, 2, 128 * 81, 8 >> lvl, 16 >> lvl)
               .reshape(2, 128, 81, 2)) for lvl in range(4) for _ in range(2)]
    cts = [T(rng.normal(size=(2, 128, 81)).astype(np.float32))
           for _ in range(16)]

    def grads(function, dtype):
        vA = [p.detach().to(dtype).clone().requires_grad_() for p in pyr_A]
        vB = [p.detach().to(dtype).clone().requires_grad_() for p in pyr_B]
        if fn == "coords":
            lookup = (corr.DCCLLevelLookupCoords.apply if function
                      else dccl_lookup.dccl_level_lookup_coords_plain)
            outs = [o for lvl in range(4) for o in lookup(
                vA[lvl], vB[lvl], cqA, cqB, scales[lvl],
                given[2 * lvl][..., 0], given[2 * lvl][..., 1],
                given[2 * lvl + 1][..., 0], given[2 * lvl + 1][..., 1])]
        elif function:
            # the four (B, Q, 4*81) fields; their cotangents are the
            # per-level ones concatenated
            outs = corr.DCCLAllLevelsLookup.apply(
                cqA, cqB, g.a2b_w2c_8, g.b2a_w2c_8, scales, True,
                *(v for pair in zip(vA, vB) for v in pair))
            torch.autograd.backward(outs, [torch.cat(cts[j::4], -1)
                                           for j in range(4)])
            return [v.grad for v in vA + vB]
        else:
            outs = [o for lv in dccl_lookup.dccl_lookup_all_levels_plain(
                vA, vB, cqA, cqB, g.a2b_w2c_8, g.b2a_w2c_8, scales)
                for o in lv]
        torch.autograd.backward(outs, cts)
        return [v.grad for v in vA + vB]

    for a, b in zip(grads(True, torch.float32), grads(False, torch.float32)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    pyr_A = [p.to(torch.bfloat16).float() for p in pyr_A]
    pyr_B = [p.to(torch.bfloat16).float() for p in pyr_B]
    for a, b in zip(grads(True, torch.bfloat16), grads(False, torch.float32)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("fuse", [False, True])
def test_all_levels_function_is_per_level_plain_then_cat(rng, fuse):
    """The grid route's Function (``DCCLAllLevelsLookup``, one launch per
    level, or one for all with ``fuse``) writes each level into its columns
    of four (B, Q, 4*81) fields: bitwise the per-level plain lookups
    followed by ``torch.cat``, f32 and bf16 volumes; its gradients equal
    autograd of ``dccl_level_lookup_plain`` (f32, 1e-5)."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    cqA, cqB = T(cA).reshape(2, 128, 2), T(cB).reshape(2, 128, 2)
    scales = tuple(1.0 / 2 ** i for i in range(4))
    gA, gB = g.a2b_w2c_8, g.b2a_w2c_8
    for dtype in (torch.float32, torch.bfloat16):
        vA = [p.to(dtype) for p in pyr_A]
        vB = [p.to(dtype) for p in pyr_B]
        got = corr.DCCLAllLevelsLookup.apply(
            cqA, cqB, gA, gB, scales, fuse,
            *(v for pair in zip(vA, vB) for v in pair))
        ref = [dccl_lookup.dccl_level_lookup_plain(vA[i], vB[i], cqA, cqB, gA,
                                                   gB, scales[i])
               for i in range(4)]
        for j, t in enumerate(got):
            assert t.shape == (2, 128, 4 * 81)
            assert torch.equal(t, torch.cat([r[j] for r in ref], -1))
    cts = [T(rng.normal(size=(2, 128, 4 * 81)).astype(np.float32))
           for _ in range(4)]

    def grads(function):
        vA = [p.detach().clone().requires_grad_() for p in pyr_A]
        vB = [p.detach().clone().requires_grad_() for p in pyr_B]
        if function:
            outs = corr.DCCLAllLevelsLookup.apply(
                cqA, cqB, gA, gB, scales, fuse,
                *(v for pair in zip(vA, vB) for v in pair))
        else:
            outs = [torch.cat(f, -1) for f in zip(*(
                dccl_lookup.dccl_level_lookup_plain(vA[i], vB[i], cqA, cqB,
                                                    gA, gB, scales[i])
                for i in range(4)))]
        torch.autograd.backward(outs, cts)
        return [v.grad for v in vA + vB]

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_level_lookup_writes_into_given_columns(rng):
    """``dccl_level_lookup(..., out=, col=)`` fills columns col .. col + 80
    of the four arrays, returns those columns and leaves the rest; the
    card's target check takes a level slice's layout and refuses others."""
    pyr_A, pyr_B, cA, cB = _dccl_inputs(rng)
    g = rotation_grids(64, 128).to_device("cpu")
    cqA, cqB = T(cA).reshape(2, 128, 2), T(cB).reshape(2, 128, 2)
    args = (pyr_A[1], pyr_B[1], cqA, cqB, g.a2b_w2c_8, g.b2a_w2c_8, 0.5)
    out = [torch.full((2, 128, 3 * 81), 7.0) for _ in range(4)]
    views = dccl_lookup.dccl_level_lookup(*args, out=out, col=81)
    for o, v, r in zip(out, views, dccl_lookup.dccl_level_lookup_plain(*args)):
        assert torch.equal(v, r) and torch.equal(o[..., 81:162], r)
        assert bool((o[..., :81] == 7.0).all() and (o[..., 162:] == 7.0).all())
    arrays, ld = dccl_lookup._targets(out, 2, 128, 162, torch.device("cpu"))
    assert ld == 3 * 81 and arrays == out
    with pytest.raises(ValueError):
        dccl_lookup._targets([o.transpose(0, 1) for o in out], 2, 128, 162,
                             torch.device("cpu"))
    with pytest.raises(ValueError):
        dccl_lookup._targets(out, 2, 128, 4 * 81, torch.device("cpu"))


@pytest.mark.parametrize("S", [1, 3])
def test_level_scatter_grid_plain_is_coords_then_scatter(rng, S):
    """The grid entry's plain version is bitwise ``grid_window_coords``
    followed by ``dccl_level_scatter_plain``, and matches the JAX
    backward's one-hot einsums (``_scatter_own_cross`` at S = 1, the
    stacked ``_scatter_grads_*_multi`` at S = 3) fed those coords, f32 to
    1e-5."""
    from prior_flow_tpu.ops.pallas import dccl_gather as jdg
    B, Q, Hl, Wl, scale = 2, 6, 8, 16, 0.5
    g_own, cen, g_cross, _, _ = _scatter_inputs(rng, S, B, Q, Hl, Wl)
    other = _centres(rng, S * B * Q, 8, 16).reshape(S, B, Q, 2)
    grid = rotation_grids(64, 128).to_device("cpu").b2a_w2c_8
    got = dccl_scatter.dccl_level_scatter_grid(T(g_own), T(cen), T(g_cross),
                                               T(other), grid, scale, Hl, Wl)
    cx, cy = dccl_lookup.grid_window_coords(T(other), grid, scale)
    ref = dccl_scatter.dccl_level_scatter_plain(T(g_own), T(cen), scale,
                                                T(g_cross), cx, cy, Hl, Wl)
    assert got.shape == (B, Q, Hl, Wl) and torch.equal(got, ref)
    j = jnp.asarray
    cx, cy = cx.numpy(), cy.numpy()
    if S == 1:
        jref = jdg._scatter_own_cross(j(g_own[0]), j(cen[0]), scale,
                                      j(g_cross[0]), j(cx[0]), j(cy[0]), Hl,
                                      Wl, jnp.float32)
    else:
        jref = (jdg._scatter_grads_window_multi(j(g_own), j(cen), scale, Hl,
                                                Wl, jnp.float32)
                + jdg._scatter_grads_multi(j(g_cross), j(cx), j(cy), Hl, Wl,
                                           jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=1e-5)


def test_scatter_reads_a_level_slice_in_place(rng):
    """A level's column slice of (S, B, Q, 4*81) cotangents gives the bits
    of its contiguous copy through both entries; the card's layout check
    reads its row stride and refuses a layout without one."""
    S, B, Q, Hl, Wl, scale = 2, 2, 5, 4, 8, 0.5
    g_own, cen, g_cross, cx, cy = (T(a) for a in _scatter_inputs(
        rng, S, B, Q, Hl, Wl, away_from_edge=False))
    wide = [T(rng.normal(size=(S, B, Q, 4 * 81)).astype(np.float32))
            for _ in range(2)]
    for t, w in zip((g_own, g_cross), wide):
        w[..., 162:243] = t
    sl = [w[..., 162:243] for w in wide]
    grid = rotation_grids(32, 64).to_device("cpu").a2b_w2c_8
    other = cen.flip(0).contiguous()
    assert torch.equal(
        dccl_scatter.dccl_level_scatter_grid(sl[0], cen, sl[1], other, grid,
                                             scale, Hl, Wl),
        dccl_scatter.dccl_level_scatter_grid(g_own, cen, g_cross, other, grid,
                                             scale, Hl, Wl))
    assert torch.equal(
        dccl_scatter.dccl_level_scatter(sl[0], cen, scale, sl[1], cx, cy, Hl,
                                        Wl),
        dccl_scatter.dccl_level_scatter(g_own, cen, scale, g_cross, cx, cy,
                                        Hl, Wl))
    assert dccl_scatter._row_stride("t", sl[0], g_own.shape) == 4 * 81
    assert dccl_scatter._row_stride("t", g_own, g_own.shape) == 81
    with pytest.raises(ValueError):
        dccl_scatter._row_stride("t", g_own.transpose(1, 2), g_own.shape)
    assert corr._rows(sl[0][0]).data_ptr() == sl[0][0].data_ptr()
    assert corr._rows(g_own[0].transpose(0, 1).contiguous().transpose(0, 1)
                      ).is_contiguous()


def test_dccl_route_rules(monkeypatch):
    """The planes route is taken exactly when the 1/8 grid is wider than
    128 columns or ``grid_in_kernel=False``, and ``record`` refuses it;
    ``fuse_levels=None`` reads ``PRIORFLOW_DCCL_FUSE_LEVELS``."""
    narrow, wide = torch.zeros(64, 128, 2), torch.zeros(64, 129, 2)
    assert not corr.DCCLFused().planes_route(narrow)
    assert corr.DCCLFused().planes_route(wide)
    assert corr.DCCLFused(grid_in_kernel=False).planes_route(narrow)
    with pytest.raises(ValueError):
        corr.DCCLFused(grid_in_kernel=False).record(
            torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2, 2), [], [],
            narrow, narrow, narrow, narrow)
    monkeypatch.delenv("PRIORFLOW_DCCL_FUSE_LEVELS", raising=False)
    assert corr.DCCLFused().fuse_levels is False
    monkeypatch.setenv("PRIORFLOW_DCCL_FUSE_LEVELS", "1")
    assert corr.DCCLFused().fuse_levels is True
    assert corr.DCCLFused(fuse_levels=False).fuse_levels is False
    monkeypatch.setenv("PRIORFLOW_DCCL_FUSE_LEVELS", "0")
    assert corr.DCCLFused().fuse_levels is False


def _away_from_seam(c, W):
    """Move x that wraps to exactly W (a hair below 0) off that edge: there
    the Pallas kernels clip to column W-1 and the port samples zero
    (ROADMAP Queue 3)."""
    c = c.copy()
    x = c[..., 0]
    x[(x < 0) & (np.mod(x, np.float32(W)) == W)] = -0.5
    return c


@pytest.mark.slow  # interpret-mode Pallas on the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookup_coords_matches_pallas_interpret(rng, dtype):
    """The plain lookup at given coords against the Pallas lookup it stands
    for (``dccl_level_lookup_fused``, kernel ``_dccl_kernel``) in interpret
    mode, away from the x == W edge, at DCCL_ATOL."""
    from prior_flow_tpu.ops.pallas.dccl_gather import dccl_level_lookup_fused
    pyr_A, pyr_B, _, _ = _dccl_inputs(rng)
    base = np.broadcast_to(jgrids.identity_grid(8, 16), (2, 8, 16, 2))
    cA = (base + rng.uniform(-3, 3, base.shape)).astype(np.float32).reshape(
        2, 128, 2)
    cB = (base + rng.uniform(-3, 3, base.shape)).astype(np.float32).reshape(
        2, 128, 2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for lvl in range(4):
        vA, vB = pyr_A[lvl].to(dtype), pyr_B[lvl].to(dtype)
        Hl, Wl = vA.shape[2:]
        s = 1.0 / 2 ** lvl
        xA, xB = (_away_from_seam(_coords(rng, 2, 128 * 81, Hl, Wl), Wl)
                  .reshape(2, 128, 81, 2) for _ in range(2))
        ref = dccl_level_lookup_fused(
            jnp.asarray(vA.float().numpy()).astype(jdt),
            jnp.asarray(vB.float().numpy()).astype(jdt),
            jnp.asarray(cA), jnp.asarray(cB), jnp.asarray(xA),
            jnp.asarray(xB), s, interpret=True)
        got = dccl_lookup.dccl_level_lookup_coords_plain(
            vA, vB, T(cA), T(cB), s, T(xA[..., 0]), T(xA[..., 1]),
            T(xB[..., 0]), T(xB[..., 1]))
        for r, t in zip(ref, got):
            np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                       atol=DCCL_ATOL, rtol=0)


@pytest.mark.slow  # interpret-mode Pallas on the CPU
def test_all_levels_matches_pallas_interpret(rng):
    """The plain all-levels lookup against ``dccl_packed_lookup_grid_all``
    (kernel ``_dccl_grid_kernel_all``) in interpret mode, centres away from
    the x == W edge, f32, at DCCL_ATOL."""
    from prior_flow_tpu.ops.pallas.dccl_gather import (
        dccl_packed_lookup_grid_all, pack_volume)
    pyr_A, pyr_B, _, _ = _dccl_inputs(rng)
    g = jgrids.rotation_grids(64, 128)
    base = np.broadcast_to(jgrids.identity_grid(8, 16), (2, 8, 16, 2))
    cA, cB = ((base + rng.uniform(-3, 3, base.shape)).astype(np.float32)
              .reshape(2, 128, 2) for _ in range(2))
    scales = tuple(1.0 / 2 ** i for i in range(4))
    pA = [pack_volume(jnp.asarray(p.numpy())) for p in pyr_A]
    pB = [pack_volume(jnp.asarray(p.numpy())) for p in pyr_B]
    ref = dccl_packed_lookup_grid_all(
        tuple(p for p, _ in pA), tuple(p for p, _ in pB),
        tuple(m for _, m in pA), jnp.asarray(cA), jnp.asarray(cB),
        (jnp.asarray(g.a2b_w2c_8), jnp.asarray(g.b2a_w2c_8)), scales, True)
    got = dccl_lookup.dccl_lookup_all_levels_plain(
        pyr_A, pyr_B, T(cA), T(cB), T(g.a2b_w2c_8), T(g.b2a_w2c_8), scales)
    for r_lv, t_lv in zip(ref, got):
        for r, t in zip(r_lv, t_lv):
            np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                       atol=DCCL_ATOL, rtol=0)
