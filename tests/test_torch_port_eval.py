"""The port's evaluation path against the JAX package on the CPU: the
geometry, sampler and warp functions the warps need (forward at 16x32 and
32x64 with seam and edge columns, and the VJPs of those built on the
samplers against ``jax.vjp``), the padder and the warm-start splat, the
spherical metrics and region masks, the colour maps, every validator with
both packages' forward replaced by one deterministic function of the
images, and end to end the evaluate and video CLIs on one ``.pth``.

Tolerances, each stated where it is used:
- WARP_ATOL 1e-5: f32 bilinear blends of O(1) payloads (pixel coordinates
  up to 64 carry 4e-6 of f32 spacing); flows are scaled by their maximum;
- ANGLE_ATOL 1e-5 rad: the sphere maps' f32 trigonometry;
- the padder, the splat, the pole masks and the region masks: exact;
- METRIC_RTOL 1e-5: the validators' metrics, relative, from one forward
  (the port sums in float64, the JAX package in f32 numpy);
- E2E_RTOL 1e-4: the evaluate CLI on one .pth, two forwards;
- FLOW_TOL 1e-3 x flow scale: the video CLI's flows (the forward gate).

Two JAX models are compiled here: the evaluate CLI's forward and the video
CLI's (64x128, 2 iterations).
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prior_flow_tpu.checkpoint.convert import export_state_dict
from prior_flow_tpu.data import frame_utils as jfu
from prior_flow_tpu.eval import evaluate as JE
from prior_flow_tpu.eval import metrics as jm
from prior_flow_tpu.geometry import erp as jerp
from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.geometry import rotation as jrot
from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
from prior_flow_tpu.ops import samplers as jsamp
from prior_flow_tpu.ops import warp as jwarp
from prior_flow_tpu.utils import flow_viz as jviz
from prior_flow_tpu.utils import padder as jpad
from prior_flow_tpu_torch.eval import evaluate as TE
from prior_flow_tpu_torch.eval import metrics as tm
from prior_flow_tpu_torch.geometry import erp as terp
from prior_flow_tpu_torch.geometry import grids as tgrids
from prior_flow_tpu_torch.geometry import rotation as trot
from prior_flow_tpu_torch.ops import samplers as tsamp
from prior_flow_tpu_torch.ops import warp as twarp
from prior_flow_tpu_torch.utils import flow_viz as tviz
from prior_flow_tpu_torch.utils import padder as tpad
from test_data import _make_flowscape_tree, _make_mpf_tree
from test_torch_port_nn import random_variables


def T(a):
    """A tensor copy of an array (JAX's host arrays are read-only)."""
    return torch.from_numpy(np.array(a))


WARP_ATOL = 1e-5
ANGLE_ATOL = 1e-5
METRIC_RTOL = 1e-5
E2E_RTOL = 1e-4
FLOW_TOL = 1e-3
SIZES = [(16, 32), (32, 64)]
R = jrot.rotation_matrix([0.3, -0.2, 0.5])


def _coords(rng, B, Q, H, W):
    """Random pixel coords plus the seam and edge cases: x in (W-1, W),
    negative x, x a hair below 0 (wraps to exactly W in f32), x beyond W,
    y outside [0, H-1]."""
    x = rng.uniform(-2 * W, 2 * W, (B, Q)).astype(np.float32)
    y = rng.uniform(-2.0, H + 1.0, (B, Q)).astype(np.float32)
    edge_x = [W - 1, W - 0.5, W - 0.01, -0.5, -1e-8, -W - 0.25, 3 * W + 0.3,
              0.0, 0.5, W - 1.5]
    edge_y = [0.0, -0.5, H - 1, H - 0.5, -1.0, H, 0.25, H - 1.25, -3.0, 2.5]
    x[:, :len(edge_x)] = edge_x
    y[:, :len(edge_y)] = edge_y
    return np.stack([x, y], axis=-1)


def _flow(rng, B, H, W, scale=5.0):
    """A flow whose end points cross the seam and leave through the poles."""
    f = (rng.normal(size=(B, H, W, 2)) * scale).astype(np.float32)
    f[:, :, -2:, 0] = np.abs(f[:, :, -2:, 0]) + 2.0      # across the seam
    f[:, :2, :, 1] = -np.abs(f[:, :2, :, 1]) - 1.0       # over the north pole
    return f


def _close(got, ref, atol=WARP_ATOL, scale=None):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    s = float(np.abs(ref).max()) if scale else 1.0
    np.testing.assert_allclose(got, ref, atol=atol * max(s, 1.0), rtol=0)


# -- geometry ---------------------------------------------------------------------

@pytest.mark.parametrize("H,W", SIZES)
def test_erp_grid_maps(rng, H, W):
    grid = np.concatenate([_coords(rng, 1, 200, H, W)[0],
                           jgrids.identity_grid(H, W).reshape(-1, 2)])
    for fn in ("plane_to_spherical", "spherical_to_plane"):
        ref = np.asarray(getattr(jerp, fn)(jnp.asarray(grid), H, W))
        _close(getattr(terp, fn)(T(grid), H, W).numpy(), ref, scale=True)
        _close(getattr(terp, fn)(grid.astype(np.float64), H, W), ref,
               scale=True)
    ref = np.asarray(jerp.spherical_to_plane(jnp.asarray(grid), H, W,
                                             is_flow=True))
    _close(terp.spherical_to_plane(T(grid), H, W, is_flow=True).numpy(), ref,
           scale=True)
    x = grid[:, 0]
    ref = np.asarray(jerp.piecewise_fun(jnp.asarray(x), W))
    assert np.array_equal(terp.piecewise_fun(T(x), W).numpy(), ref)
    assert np.array_equal(terp.piecewise_fun(x, W), ref)


@pytest.mark.parametrize("H,W", SIZES)
def test_grids_and_rotation(rng, H, W):
    assert np.array_equal(tgrids.identity_grid(H, W),
                          jgrids.identity_grid(H, W))
    for angles in [(0.0, 0.0, 0.3), (0.0, -np.pi / 2, 0.0)]:
        for tr in (False, True):
            assert np.array_equal(tgrids.sample_grid(H, W, angles, tr),
                                  jgrids.sample_grid(H, W, angles, tr))
    assert np.array_equal(trot.make_sample_grid_sized(H, W, 2 * H, W // 2, R),
                          jrot.make_sample_grid_sized(H, W, 2 * H, W // 2, R))
    sph = rng.uniform(-3, 3, (7, 9, 2)).astype(np.float32)
    cart = np.asarray(jrot.spherical_to_cartesian(jnp.asarray(sph)))
    _close(trot.spherical_to_cartesian(T(sph)).numpy(), cart, ANGLE_ATOL)
    rot = np.asarray(jrot.rotate_cartesian(jnp.asarray(cart), R))
    _close(trot.rotate_cartesian(T(cart), R).numpy(), rot, ANGLE_ATOL)
    assert np.array_equal(trot.rotate_cartesian(cart.astype(np.float64), R),
                          jrot.rotate_cartesian(cart.astype(np.float64), R))
    _close(trot.cartesian_to_spherical(T(rot)).numpy(),
           np.asarray(jrot.cartesian_to_spherical(jnp.asarray(rot))),
           ANGLE_ATOL)


# -- samplers ---------------------------------------------------------------------

def _vjp_pair(jfn, tfn, args, rng):
    """Forward and VJP of ``jfn`` (JAX) and ``tfn`` (torch) at ``args``
    against one random cotangent; returns (forward, grads) for each."""
    jout, jvjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    ct = rng.normal(size=np.shape(jout)).astype(np.float32)
    jgrads = jvjp(jnp.asarray(ct))
    targs = [T(a.copy()).requires_grad_() for a in args]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(tout, targs, T(ct))
    return ((np.asarray(jout), [np.asarray(g) for g in jgrads]),
            (tout.detach().numpy(), [g.numpy() for g in tgrads]))


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("cyclic", [False, True])
def test_samplers_mask_option(rng, H, W, cyclic):
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    coords = _coords(rng, 2, 96, H, W).reshape(2, 8, 12, 2)
    name = "cycle_bilinear_sample" if cyclic else "bilinear_sample"
    ref, rmask = getattr(jsamp, name)(jnp.asarray(img), jnp.asarray(coords),
                                      mask=True)
    got, gmask = getattr(tsamp, name)(T(img), T(coords), mask=True)
    _close(got.numpy(), ref)
    assert np.array_equal(gmask.numpy(), np.asarray(rmask))


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("fn", ["masked", "cycle", "cycle_nearest"])
def test_masked_and_cycle_interpolation(rng, H, W, fn):
    """Forward and, but for the nearest variant (a gather: no coordinate
    gradient), the VJP in both the image and the grid."""
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    grid = _coords(rng, 2, 96, H, W).reshape(2, 8, 12, 2)
    jf, tf = {"masked": (jsamp.masked_bilinear_interpolate,
                         tsamp.masked_bilinear_interpolate),
              "cycle": (jsamp.cycle_interpolate, tsamp.cycle_interpolate),
              "cycle_nearest": (
                  lambda i, g: jsamp.cycle_interpolate(i, g, nearest=True),
                  lambda i, g: tsamp.cycle_interpolate(i, g, nearest=True)),
              }[fn]
    if fn == "cycle_nearest":
        ref = np.asarray(jf(jnp.asarray(img), jnp.asarray(grid)))
        assert np.array_equal(tf(T(img), T(grid)).numpy(), ref)
        return
    (jo, jg), (to, tg) = _vjp_pair(jf, tf, [img, grid], rng)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b, scale=True)


# -- warps ------------------------------------------------------------------------

@pytest.mark.parametrize("H,W", SIZES + [(15, 30)])
@pytest.mark.parametrize("fn", ["img_a2b", "img_b2a"])
def test_image_rotations(rng, H, W, fn):
    """Both branches of ``img_a2b`` / ``img_b2a``: the bundle's grid at
    multiples of 8, ``sample_grid`` otherwise (15x30); VJP in the image."""
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    (jo, jg), (to, tg) = _vjp_pair(getattr(jwarp, fn), getattr(twarp, fn),
                                   [img], rng)
    _close(to, jo)
    _close(tg[0], jg[0], scale=True)


@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("fn", ["flo_b2a", "coord_a2b", "coord_b2a",
                                "downflow8", "upflow8"])
def test_flow_and_coordinate_warps(rng, H, W, fn):
    """Forward and VJP in the field. ``upflow8``/``downflow8`` sample at
    ``linspace`` coordinates that may differ from XLA's in the last bit,
    so they are held to WARP_ATOL of the flow scale."""
    if fn.startswith("coord"):
        field = np.broadcast_to(jgrids.identity_grid(H, W), (2, H, W, 2))
        field = (field + _flow(rng, 2, H, W, 2.0)).astype(np.float32)
    else:
        field = _flow(rng, 2, H, W)
    (jo, jg), (to, tg) = _vjp_pair(getattr(jwarp, fn), getattr(twarp, fn),
                                   [field], rng)
    _close(to, jo, scale=True)
    _close(tg[0], jg[0], scale=True)


@pytest.mark.parametrize("H,W", SIZES)
def test_cycle_warp_and_legacy_warp(rng, H, W):
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    flow = _flow(rng, 2, H, W)
    (jo, jg), (to, tg) = _vjp_pair(jwarp.cycle_warp, twarp.cycle_warp,
                                   [img, flow], rng)
    _close(to, jo)
    for a, b in zip(tg, jg):
        _close(a, b, scale=True)
    for cyclic in (False, True):
        (jo, jg), (to, tg) = _vjp_pair(
            lambda i, f: jwarp.legacy_warp(i, f, cyclic)[0],
            lambda i, f: twarp.legacy_warp(i, f, cyclic)[0], [img, flow], rng)
        _close(to, jo)
        for a, b in zip(tg, jg):
            _close(a, b, scale=True)
        jmask = np.asarray(jwarp.legacy_warp(jnp.asarray(img),
                                             jnp.asarray(flow), cyclic)[1])
        assert np.array_equal(
            twarp.legacy_warp(T(img), T(flow), cyclic)[1].numpy(), jmask)


@pytest.mark.parametrize("H,W", SIZES)
def test_theta_rotations(rng, H, W):
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    flow = _flow(rng, 2, H, W)
    for theta in (0.4, -np.pi / 2):
        _close(twarp.img_rotate_theta(T(img), theta).numpy(),
               np.asarray(jwarp.img_rotate_theta(jnp.asarray(img), theta)))
        _close(twarp.flo_rotate_theta(T(flow), theta).numpy(),
               np.asarray(jwarp.flo_rotate_theta(jnp.asarray(flow), theta)),
               scale=True)


@pytest.mark.parametrize("H,W", SIZES)
def test_flow_to_camera(rng, H, W):
    flow = _flow(rng, 2, H, W)
    ref = np.asarray(jwarp.flow_to_camera(jnp.asarray(flow), R))
    _close(twarp.flow_to_camera(T(flow), R).numpy(), ref, scale=True)


@pytest.mark.parametrize("H,W", SIZES)
def test_rotating_warping(rng, H, W):
    """Forward and VJP in the features, at per-candidate coords on an
    (H, W) grid sampling an (H/2, W/2) source. The sphere maps' f32
    trigonometry moves a sample coordinate by a few f32 spacings of W
    (3.8e-6 px at 32), times the random features' slope (up to ~8): the
    forward is held to 5e-5."""
    feat = rng.normal(size=(2, H // 2, W // 2, 4)).astype(np.float32)
    coords = (rng.uniform(0, 1, (2, 3, H, W, 2)) * [W, H]).astype(np.float32)
    (jo, jg), (to, tg) = _vjp_pair(
        lambda f: jwarp.rotating_warping(f, R, jnp.asarray(coords)),
        lambda f: twarp.rotating_warping(f, R, T(coords)), [feat], rng)
    _close(to, jo, 5e-5)
    _close(tg[0], jg[0], scale=True)


# -- padder and the warm-start splat ---------------------------------------------

@pytest.mark.parametrize("mode", ["sintel", "kitti"])
@pytest.mark.parametrize("H,W", [(13, 29), (16, 35), (21, 32), (16, 32)])
def test_input_padder_bitwise(rng, mode, H, W):
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    y = rng.normal(size=(2, H, W, 2)).astype(np.float32)
    jp, tp = jpad.InputPadder(x.shape, mode), tpad.InputPadder(x.shape, mode)
    ja, jb = jp.pad(jnp.asarray(x), jnp.asarray(y))
    ta, tb = tp.pad(T(x), T(y))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert ta.shape[1] % 8 == 0 and ta.shape[2] % 8 == 0
    assert np.array_equal(tp.unpad(ta).numpy(), x)
    assert np.array_equal(tp.unpad(ta).numpy(), np.asarray(jp.unpad(ja)))
    assert np.array_equal(tp.pad(T(x)).numpy(), np.asarray(jp.pad(
        jnp.asarray(x))))


def test_forward_interpolate_bitwise(rng):
    flow = _flow(rng, 1, 12, 24, 3.0)[0]
    ref = jpad.forward_interpolate(flow)
    assert np.array_equal(tpad.forward_interpolate(flow), ref)
    assert np.array_equal(tpad.forward_interpolate(T(flow)), ref)


# -- metrics ----------------------------------------------------------------------

@pytest.mark.parametrize("H,W", SIZES)
@pytest.mark.parametrize("method", ["Haversine", "Cosine"])
def test_great_circle_distance(rng, H, W, method):
    """Haversine to 2e-6 rad. The Cosine form takes the arccos of a value
    near 1 for short arcs, where one f32 rounding of cos_a moves the angle
    by up to sqrt(2 * 2^-24) = 3.5e-4 rad: it is held to that bound."""
    pred, gt = _flow(rng, 2, H, W), _flow(rng, 2, H, W)
    gt[:, 0] = pred[:, 0]                    # zero distance on one row
    gt[:, 1] = pred[:, 1] + 1e-3             # and near zero on the next
    ref = np.asarray(jm.great_circle_distance(jnp.asarray(pred),
                                              jnp.asarray(gt), method))
    got = tm.great_circle_distance(T(pred), T(gt), method).numpy()
    atol = 2e-6 if method == "Haversine" else 3.5e-4
    _close(got, ref, atol)
    with pytest.raises(ValueError):
        tm.great_circle_distance(T(pred), T(gt), "Vincenty")


@pytest.mark.parametrize("H,W", SIZES)
def test_spherical_flow_magnitude_and_epe(rng, H, W):
    pred, gt = _flow(rng, 2, H, W), _flow(rng, 2, H, W)
    _close(tm.spherical_flow_magnitude(T(pred)).numpy(),
           np.asarray(jm.spherical_flow_magnitude(jnp.asarray(pred))), 2e-6)
    _close(tm.epe(T(pred), T(gt)).numpy(),
           np.asarray(jm.epe(jnp.asarray(pred), jnp.asarray(gt))), 1e-6,
           scale=True)
    assert np.array_equal(tm.spherical_mask(H, W), jm.spherical_mask(H, W))


@pytest.mark.parametrize("H,W", [(16, 32), (32, 64), (64, 128), (15, 30),
                                 (128, 256)])
@pytest.mark.parametrize("which", ["b", "d"])
def test_pole_masks_exact(H, W, which):
    """The pole masks equal JAX's exactly. Where a pixel of the rotated mask
    flips, its value before the 0.5 threshold lies within 1e-6 of 0.5 (in
    both packages' f32), so the flip is a rounding tie, not a fault."""
    fn = "generate_polemask" if which == "b" else "generate_polemask_d"
    ja, jr = getattr(jm, fn)(H, W)
    ta, tr = getattr(tm, fn)(H, W)
    assert np.array_equal(ta, ja)
    flips = tr != jr
    if flips.any():
        grid = (tgrids.view_grid(H, W, "a2b") if which == "b" else
                tgrids.sample_grid(H, W, (0.0, -np.pi / 2, 0.0)))
        pre = tm.rotated_pole(ta.astype(np.float32), grid)
        assert np.abs(pre[flips] - 0.5).max() <= 1e-6
    else:
        assert np.array_equal(tr, jr)


@pytest.mark.parametrize("H,W", [(16, 32), (64, 128)])
def test_region_masks_exact(H, W):
    ref, got = jm.region_masks(H, W), tm.region_masks(H, W)
    assert list(got) == list(ref) == list(tm.REGIONS)
    for k in ref:
        assert got[k].dtype == bool and np.array_equal(got[k], ref[k])


# -- colour maps ------------------------------------------------------------------

def test_colour_maps_match_jax(rng):
    flow = _flow(rng, 1, 16, 32)[0]
    assert np.array_equal(tviz.make_colorwheel(), jviz.make_colorwheel())
    for fn in ("flow_to_image", "better_flow_to_image"):
        assert np.array_equal(getattr(tviz, fn)(flow), getattr(jviz, fn)(flow))
    got, ref = tviz.omniflow_to_image(flow), jviz.omniflow_to_image(flow)
    # the arc lengths differ by f32 rounding (2e-6 rad): a colour step
    # may move by one level where the floor meets a boundary
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert np.array_equal(tviz.omniflow_to_image(np.transpose(flow, (2, 0, 1))),
                          got)


def test_save_gif_writes_a_webp(rng, tmp_path):
    img1 = rng.integers(0, 255, (64, 128, 3)).astype(np.float32)
    img2 = rng.integers(0, 255, (64, 128, 3)).astype(np.float32)
    out = tviz.save_gif(img1, img2, _flow(rng, 1, 64, 128)[0], "g",
                        str(tmp_path))
    assert out.endswith(".webp") and os.path.getsize(out) > 0


# -- validators, one forward for both packages ----------------------------------

def _forward_np(i1, i2, xp):
    """One deterministic 'model': a flow from the images, computed alike
    by numpy-like ``xp`` (jnp or torch)."""
    u = (i1 - i2).mean(-1) / 16.0
    v = (i1 + i2).mean(-1) / 64.0 - 3.5
    return xp.stack([u, v], -1)


class _Shared(torch.nn.Module):
    """A port 'model' (no weights: the CPU) for the patched forward."""


@pytest.fixture
def shared_forward(monkeypatch):
    monkeypatch.setattr(JE, "make_forward", lambda model, variables, iters:
                        lambda a, b: _forward_np(a, b, jnp))
    monkeypatch.setattr(TE, "make_forward", lambda model, iters:
                        lambda a, b: _forward_np(a, b, torch))


def _flat(res):
    out = {}
    for k, v in res.items():
        out.update({f"{k}-{m}": x for m, x in v.items()}
                   if isinstance(v, dict) else {k: v})
    return out


def _metrics_close(got, ref, rtol):
    got, ref = _flat(got), _flat(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.isfinite(got[k])
        assert abs(got[k] - ref[k]) <= rtol * abs(ref[k]), (k, got[k], ref[k])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The MPF test split (EFT and a City twin) at 24x44, which the padder
    widens to 24x48, and FlowScape at 32x64."""
    mpf = _make_mpf_tree(str(tmp_path_factory.mktemp("mpf")), n=4, H=24,
                         W=44)
    shutil.copytree(osp.join(mpf, "EFTs_Car100"), osp.join(mpf, "City_100_r"))
    fs = _make_flowscape_tree(str(tmp_path_factory.mktemp("fs")), n=4,
                              H=32, W=64)
    return mpf, fs


VALIDATORS = [("validate_mpf", "mpf", {"scene": "EFT"}),
              ("validate_mpf", "mpf", {"scene": "all"}),
              ("validate_flowscape", "fs", {"scene": "sunny"}),
              ("validate_mpf_regions", "mpf", {"scene": "EFT"}),
              ("validate_flowscape_regions", "fs", {"scene": "sunny"}),
              ("validate_city_regions", "mpf", {})]


@pytest.mark.parametrize("name,tree,kw", VALIDATORS,
                         ids=[f"{n}-{k.get('scene', 'City')}"
                              for n, _, k in VALIDATORS])
def test_validators_match_jax(trees, shared_forward, name, tree, kw):
    """Every panoramic validator on one shared forward: the same metrics to
    METRIC_RTOL, over the padded 24x44 MPF tree and FlowScape."""
    root = trees[0] if tree == "mpf" else trees[1]
    ref = getattr(JE, name)(None, None, iters=2, data_root=root, **kw)
    got = getattr(TE, name)(_Shared(), iters=2, data_root=root, **kw)
    _metrics_close(got, ref, METRIC_RTOL)


@pytest.mark.parametrize("name", ["validate_mpf", "validate_mpf_regions",
                                  "validate_city_regions"])
def test_batch_2_equals_batch_1(trees, shared_forward, name):
    """3 samples at batch 2 (a group of 2, then a short group of 1) give
    the batch-1 metrics."""
    one = getattr(TE, name)(_Shared(), iters=2, data_root=trees[0])
    two = getattr(TE, name)(_Shared(), iters=2, data_root=trees[0],
                            batch_size=2)
    _metrics_close(two, one, METRIC_RTOL)


def test_oracle_gives_zero_error(trees):
    """A model that returns the ground truth: EPE < 1e-5, SEPE < 1e-4."""
    from prior_flow_tpu_torch.data.datasets import MPFDataset
    val = MPFDataset(split="test", scene="EFT", root=trees[0])

    class Oracle(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.k = 0

        def forward(self, i1, i2, iters=12):
            self.k += 1
            gt = T(val[self.k - 1][2])[None]
            return tpad.InputPadder(gt.shape).pad(gt)   # padded to 24x48

    res = TE.validate_mpf(Oracle(), data_root=trees[0])
    assert res["EFT-epe"] < 1e-5 and res["EFT-SEPE"] < 1e-4


def test_clock_counts_every_stage(trees, shared_forward):
    clock = TE.EvalClock()
    TE.validate_mpf_regions(_Shared(), iters=2, data_root=trees[0],
                            clock=clock)
    assert clock.pairs == 3
    assert set(clock.seconds) == {"read", "pad", "forward", "metrics"}


def _perspective_trees(root):
    """Sintel training (clean, final), FlyingChairs and KITTI 2015 trees at
    20x36 (padded to 24x40)."""
    from PIL import Image
    rng = np.random.default_rng(3)
    h, w = 20, 36

    def img(path):
        os.makedirs(osp.dirname(path), exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)

    def flo(path):
        os.makedirs(osp.dirname(path), exist_ok=True)
        jfu.write_flo(path, (rng.normal(size=(h, w, 2)) * 3).astype(
            np.float32))

    sintel = osp.join(root, "sintel")
    for dstype in ("clean", "final"):
        for i in range(3):
            img(osp.join(sintel, "training", dstype, "alley", f"f{i}.png"))
    for i in range(2):
        flo(osp.join(sintel, "training", "flow", "alley", f"f{i}.flo"))
    chairs = osp.join(root, "chairs")
    for i in range(3):
        img(osp.join(chairs, f"{i:05d}_img1.ppm"))
        img(osp.join(chairs, f"{i:05d}_img2.ppm"))
        flo(osp.join(chairs, f"{i:05d}_flow.flo"))
    np.savetxt(osp.join(root, "chairs_split.txt"), [2, 1, 2], fmt="%d")
    kitti = osp.join(root, "kitti")
    os.makedirs(osp.join(kitti, "training", "flow_occ"))
    for i in range(3):
        img(osp.join(kitti, "training", "image_2", f"{i:06d}_10.png"))
        img(osp.join(kitti, "training", "image_2", f"{i:06d}_11.png"))
        jfu.write_flow_kitti(osp.join(kitti, "training", "flow_occ",
                                      f"{i:06d}_10.png"),
                             rng.uniform(-20, 20, (h, w, 2)))
    return sintel, chairs, kitti


def test_perspective_validators_match_jax(tmp_path, shared_forward,
                                          monkeypatch):
    sintel, chairs, kitti = _perspective_trees(str(tmp_path))
    _metrics_close(TE.validate_sintel(_Shared(), data_root=sintel),
                   JE.validate_sintel(None, None, data_root=sintel),
                   METRIC_RTOL)
    _metrics_close(TE.validate_kitti(_Shared(), data_root=kitti,
                                     batch_size=2),
                   JE.validate_kitti(None, None, data_root=kitti),
                   METRIC_RTOL)
    monkeypatch.chdir(tmp_path)                # chairs_split.txt
    _metrics_close(TE.validate_chairs(_Shared(), data_root=chairs),
                   JE.validate_chairs(None, None, data_root=chairs),
                   METRIC_RTOL)


# -- the CLIs end to end -----------------------------------------------------------

@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """A 64x128 MPF tree and a .pth of seeded JAX weights, shared."""
    root = str(tmp_path_factory.mktemp("e2e"))
    tree = _make_mpf_tree(osp.join(root, "tree"), n=4, H=64, W=128)
    jmodel = JaxPriOrRAFT(precision="highest")
    img = jnp.zeros((1, 64, 128, 3))
    variables = random_variables(jmodel, img, img, iters=1)
    pth = osp.join(root, "w.pth")
    torch.save({k: T(np.asarray(v)) for k, v in
                export_state_dict(variables).items()}, pth)
    return root, tree, pth


def test_evaluate_cli_matches_jax_end_to_end(e2e, monkeypatch):
    """The JAX CLI reads its validators from the ``prior_flow_tpu.eval``
    package; its result is captured there."""
    from prior_flow_tpu import eval as jeval
    from prior_flow_tpu.cli import evaluate as jcli
    from prior_flow_tpu_torch.cli import evaluate as tcli
    _, tree, pth = e2e
    args = ["--model", pth, "--dataset", "MPFDataset", "--scene", "EFT",
            "--data_root", tree, "--iters", "2"]
    captured = {}
    orig = jeval.validate_mpf

    def keep(*a, **k):
        captured["res"] = orig(*a, **k)
        return captured["res"]

    monkeypatch.setattr(jeval, "validate_mpf", keep)
    jcli.main(args)
    got = tcli.main(args + ["--device", "cpu"])
    _metrics_close(got, captured["res"], E2E_RTOL)


def test_video_cli_warm_start_matches_jax(e2e):
    from prior_flow_tpu.cli import video as jcli
    from prior_flow_tpu_torch.cli import video as tcli
    root, tree, pth = e2e
    frames = osp.join(tree, "EFTs_Car100", "image")
    args = ["--model", pth, "--input", frames, "--iters", "2",
            "--warm_start", "--max_pairs", "3"]
    jcli.main(args + ["--output", osp.join(root, "vj")])
    tcli.main(args + ["--output", osp.join(root, "vt"), "--device", "cpu"])
    names = sorted(f for f in os.listdir(osp.join(root, "vj"))
                   if f.endswith(".flo"))
    assert len(names) == 3
    for f in names:
        ref = jfu.read_flo(osp.join(root, "vj", f))
        got = jfu.read_flo(osp.join(root, "vt", f))
        assert np.abs(got - ref).max() <= FLOW_TOL * np.abs(ref).max()


def test_demo_image_cli_writes_a_png(e2e):
    from prior_flow_tpu_torch.cli import demo_image
    root, tree, pth = e2e
    frames = osp.join(tree, "EFTs_Car100", "image")
    out = osp.join(root, "flow_pr.png")
    flow = demo_image.main(["--model", pth, "--image1",
                            osp.join(frames, "0001.png"), "--image2",
                            osp.join(frames, "0000.png"), "--output", out,
                            "--iters", "1", "--device", "cpu", "--size", "48",
                            "96"])
    assert flow.shape == (48, 96, 2) and np.isfinite(flow).all()
    assert jfu.read_image(out).shape == (48, 96, 3)


def test_resize_matches_jax_image_resize(rng):
    """``demo_image --size``: the antialiased bilinear resize against
    ``jax.image.resize(..., "bilinear")``, shrinking and growing, within
    1e-3 of the 0-255 range."""
    from prior_flow_tpu_torch.cli.demo_image import resize_bilinear
    img = rng.uniform(0, 255, (1, 30, 50, 3)).astype(np.float32)
    for size in ((12, 20), (45, 70)):
        ref = np.asarray(jax.image.resize(jnp.asarray(img),
                                          (1, *size, 3), "bilinear"))
        _close(resize_bilinear(T(img), size).numpy(), ref, 1e-3 * 255)


def test_cli_entry_points_refuse_the_cpu_unasked_and_orbax_dirs(e2e):
    """Without ``--device`` the CLIs run on the card, and raise where there
    is none; an Orbax directory raises, pointing at the converter."""
    from prior_flow_tpu_torch.cli import demo_image, evaluate, video
    root, tree, pth = e2e
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            evaluate.main(["--model", pth, "--dataset", "MPFDataset",
                           "--data_root", tree])
        with pytest.raises(RuntimeError, match="CUDA"):
            video.main(["--model", pth, "--input",
                        osp.join(tree, "EFTs_Car100", "image")])
        with pytest.raises(RuntimeError, match="CUDA"):
            demo_image.main(["--model", pth])
    with pytest.raises(ValueError, match="convert_orbax.py"):
        demo_image.load_model_state(root)
