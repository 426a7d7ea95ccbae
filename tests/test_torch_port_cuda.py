"""The port's CUDA kernels against their plain versions, the DCCL routes
against each other, and a forward and a train step on the card against
the CPU.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it runs as it is on a machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import pytest
import torch

from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.models import build_model
from prior_flow_tpu_torch.ops import corr
from prior_flow_tpu_torch.ops.kernels import (WRAPPERS, anchors, dccl_coords,
                                              dccl_lookup, dccl_scatter,
                                              dccl_stages, gridwin_variants,
                                              instance_norm, launch_counts,
                                              reset_launch_counts)
from prior_flow_tpu_torch.train import make_optimizer, make_train_step

pytestmark = pytest.mark.cuda

LOOKUP_ATOL = 2e-5   # unit-scale volumes; kernel and plain round alike


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts(**nonzero):
    """Launch counts with the given wrappers' and 0 for every other."""
    return {**dict.fromkeys(WRAPPERS, 0), **nonzero}


def _level_inputs(dev, B, h, w, lvl, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    Hl, Wl = h >> lvl, w >> lvl
    Q = h * w
    vA = torch.randn(B, Q, Hl, Wl, generator=g).to(dtype)
    vB = torch.randn(B, Q, Hl, Wl, generator=g).to(dtype)
    u = torch.rand(2, B, Q, generator=g)
    cen = torch.stack([u[0] * (w + 4) - 2, u[1] * (h + 4) - 2], dim=-1)
    edge = torch.tensor([[w - 1, 0.0], [w - 0.5, h - 1], [-1e-8, 2.0],
                         [-0.5, -0.5], [2 * w + 0.25, h - 0.5],
                         [w - 1e-3, 1.5]])
    cen[0, :edge.shape[0]] = edge
    cenB = torch.roll(cen, 1, dims=1) + 0.37
    grids = rotation_grids(8 * h, 8 * w).to_device(dev)
    return ([t.to(dev).contiguous() for t in (vA, vB, cen, cenB)]
            + [grids.a2b_w2c_8, grids.b2a_w2c_8])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_dccl_kernel_matches_plain(dev, dtype, lvl):
    vA, vB, cA, cB, gA, gB = _level_inputs(dev, 2, 16, 32, lvl, dtype)
    scale = 1.0 / 2 ** lvl
    with torch.no_grad():
        n0 = dccl_lookup.dccl_level_lookup.launches
        got = dccl_lookup.dccl_level_lookup(vA, vB, cA, cB, gA, gB, scale)
        torch.cuda.synchronize()
        assert dccl_lookup.dccl_level_lookup.launches == n0 + 1
        ref = dccl_lookup.dccl_level_lookup_plain(vA, vB, cA, cB, gA, gB,
                                                  scale)
    for o, r in zip(got, ref):
        assert o.shape == r.shape and o.dtype == torch.float32
        err = (o - r).abs().max().item()
        assert err <= LOOKUP_ATOL, err


def test_dccl_kernel_refuses_bad_inputs(dev):
    vA, vB, cA, cB, gA, gB = _level_inputs(dev, 1, 8, 16, 0, torch.float32)
    lookup = dccl_lookup.dccl_level_lookup
    with pytest.raises(RuntimeError):
        lookup(vA.requires_grad_(), vB, cA, cB, gA, gB, 1.0)
    vA = vA.detach()
    with pytest.raises(TypeError):
        lookup(vA.half(), vB.half(), cA, cB, gA, gB, 1.0)
    with pytest.raises(ValueError):
        lookup(vA.transpose(2, 3), vB.transpose(2, 3), cA, cB, gA, gB, 1.0)
    with pytest.raises(ValueError):
        lookup(vA, vB, cA[:, :-1], cB, gA, gB, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 64, 32, 64), (2, 3, 5, 7),
                                   (1, 96, 16, 32)])
def test_instance_norm_sums_matches_plain(dev, dtype, shape):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 3 + 1.5).to(dtype).to(dev)
    y = torch.randn(shape, generator=g).to(dtype).to(dev)
    with torch.no_grad():
        for a, b in ((x, x), (x, y)):
            got = instance_norm.instance_norm_sums(a, b)
            ref = instance_norm.instance_norm_sums_plain(a, b)
            for o, r in zip(got, ref):
                torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-4)
        # a view one element into a buffer: unaligned rows take the
        # scalar loop
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        buf[1:] = x.reshape(-1)
        xs = buf[1:].reshape(shape)
        got = instance_norm.instance_norm_sums(xs, xs)
        ref = instance_norm.instance_norm_sums_plain(xs, xs)
        for o, r in zip(got, ref):
            torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-4)


def test_forward_on_card_matches_cpu_and_counts_launches(dev):
    iters = 3
    cpu = build_model("cpu", seed=5)
    card = build_model(dev, seed=5)
    g = torch.Generator().manual_seed(9)
    i1 = torch.rand(1, 64, 128, 3, generator=g) * 255
    i2 = torch.rand(1, 64, 128, 3, generator=g) * 255
    ref = cpu(i1, i2, iters=iters)
    reset_launch_counts()
    out = card(i1.to(dev), i2.to(dev), iters=iters)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(dccl_level_lookup=4 * iters,
                                      instance_norm_sums=15)
    err = (out.cpu() - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item(), err


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_coords_kernel_is_bitwise_plain_and_the_lookups_own(dev, lvl):
    """Cross tap coords: bitwise equal to the plain version, and the lookup
    kernel's cross outputs are bitwise the plain sampler of the other
    volume at these coords."""
    vA, vB, cA, cB, gA, gB = _level_inputs(dev, 2, 16, 32, lvl, torch.float32)
    scale = 1.0 / 2 ** lvl
    with torch.no_grad():
        n0 = dccl_coords.dccl_grid_coords.launches
        cx, cy = dccl_coords.dccl_grid_coords(cA.reshape(-1, 2), gA, scale)
        torch.cuda.synchronize()
        assert dccl_coords.dccl_grid_coords.launches == n0 + 1
        rx, ry = dccl_coords.dccl_grid_coords_plain(cA.reshape(-1, 2), gA,
                                                    scale)
        assert torch.equal(cx, rx) and torch.equal(cy, ry)
        _, cross_A, _, _ = dccl_lookup.dccl_level_lookup(vA, vB, cA, cB, gA,
                                                         gB, scale)
        at = torch.stack([cx, cy], -1).reshape(*cA.shape[:2], 81, 2)
        assert torch.equal(cross_A, dccl_lookup.sample_volume_level(vB, at))


def _centres(dev, B, Q, h, w, seed):
    """(B, Q, 2) unscaled centres of an (8h, 8w) input over the image and a
    margin, with the seam, a hair below 0 and the pole rows."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(2, B, Q, generator=g)
    c = torch.stack([u[0] * (w + 4) - 2, u[1] * (h + 4) - 2], -1)
    c[0, :6] = torch.tensor([[w - 1, 0.0], [w - 0.5, h - 1], [-1e-8, 5.0],
                             [-0.5, -0.5], [w - 1e-3, h - 0.5],
                             [0.0, h - 1.0]])
    return c.to(dev).contiguous()


@pytest.mark.parametrize("size,B,Q", [
    pytest.param((512, 1024), 1, 8192, id="512x1024"),
    pytest.param((1024, 2048), 1, 32768, id="1024x2048"),
    pytest.param((512, 1024), 3, 2731, id="odd-tail")])
def test_cross_coords_kernel_is_bitwise_plain(dev, size, B, Q):
    """The both-branch all-levels entry (the planes route's call: four
    levels, both branches, one launch) bitwise against its plain version at
    the level shapes of a 512x1024 and a 1024x2048 input, and at an odd
    B x Q (8193: a partial last block, and level rows that start off a
    16-byte boundary)."""
    h, w = size[0] // 8, size[1] // 8
    cens = [_centres(dev, B, Q, h, w, seed) for seed in (1, 2)]
    grids = rotation_grids(*size).to_device(dev)
    gA, gB = grids.a2b_w2c_8, grids.b2a_w2c_8
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    with torch.no_grad():
        n0 = dccl_coords.dccl_cross_coords.launches
        got = dccl_coords.dccl_cross_coords(*cens, gA, gB, scales)
        torch.cuda.synchronize()
        assert dccl_coords.dccl_cross_coords.launches == n0 + 1
        ref = dccl_coords.dccl_cross_coords_plain(*cens, gA, gB, scales)
    for o, r in zip(got, ref):
        assert o.shape == (4 * B * Q, 81) and torch.equal(o, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_1_cross_taps_at_the_cross_coords(dev, dtype):
    """At every level of a 512x1024 input (Q = 8192), kernel 1's cross taps
    are bitwise the plain sampler of the other volume at the both-branch
    entry's coords, in both branches."""
    h, w, Q = 64, 128, 8192
    cA, cB = (_centres(dev, 1, Q, h, w, seed) for seed in (3, 4))
    grids = rotation_grids(8 * h, 8 * w).to_device(dev)
    gA, gB = grids.a2b_w2c_8, grids.b2a_w2c_8
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        planes = dccl_coords.dccl_cross_coords(cA, cB, gA, gB, scales)
        for lvl, s in enumerate(scales):
            vA, vB = (torch.randn(1, Q, h >> lvl, w >> lvl, generator=g)
                      .to(dtype).to(dev) for _ in range(2))
            xA, yA, xB, yB = (p[lvl * Q:(lvl + 1) * Q] for p in planes)
            _, cross_A, _, cross_B = dccl_lookup.dccl_level_lookup(
                vA, vB, cA, cB, gA, gB, s)
            for cross, other, x, y in ((cross_A, vB, xA, yA),
                                       (cross_B, vA, xB, yB)):
                at = torch.stack([x, y], -1).reshape(1, Q, 81, 2)
                assert torch.equal(cross,
                                   dccl_lookup.sample_volume_level(other, at))


def test_grid_coords_kernel_is_bitwise_plain_at_the_training_batch(dev):
    """The one-branch one-level entry at the training batch (B = 4 at
    512x1024, 32768 centres), every level, both grids: bitwise its plain
    version."""
    cen = _centres(dev, 4, 8192, 64, 128, 6).reshape(-1, 2)
    grids = rotation_grids(512, 1024).to_device(dev)
    with torch.no_grad():
        for grid in (grids.a2b_w2c_8, grids.b2a_w2c_8):
            for lvl in range(4):
                s = 1.0 / 2 ** lvl
                got = dccl_coords.dccl_grid_coords(cen, grid, s)
                ref = dccl_coords.dccl_grid_coords_plain(cen, grid, s)
                assert all(torch.equal(o, r) for o, r in zip(got, ref))


def test_precision_highest_forward_on_card_matches_cpu(dev):
    """``build_model(precision="highest")`` under torch's default flags
    (TF32 on for cuDNN convolutions) against the CPU at the forward gate of
    chip_smoke.py (128x256, 4 iterations, 1e-3 x flow scale); the caller's
    flags are back after the call."""
    g = torch.Generator().manual_seed(11)
    i1, i2 = (torch.rand(1, 128, 256, 3, generator=g) * 255 for _ in range(2))
    ref = build_model("cpu", seed=5)(i1, i2, iters=4)
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = build_model(dev, seed=5, precision="highest")
        out = card(i1.to(dev), i2.to(dev), iters=4).cpu()
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = False
    err = (out - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 3])
def test_scatter_kernel_matches_plain(dev, dtype, S):
    g = torch.Generator().manual_seed(S)
    B, Q, Hl, Wl, scale = 2, 64, 16, 32, 0.5
    g_own = torch.randn(S, B, Q, 81, generator=g)
    g_cross = torch.randn(S, B, Q, 81, generator=g)
    cen = torch.stack([torch.rand(S, B, Q, generator=g) * (2 * Wl + 8) - 4,
                       torch.rand(S, B, Q, generator=g) * (2 * Hl + 8) - 4],
                      -1)
    cx = torch.rand(S, B, Q, 81, generator=g) * 3 * Wl - Wl
    cy = torch.rand(S, B, Q, 81, generator=g) * (Hl + 3) - 2
    cx[0, 0, 0, :3] = torch.tensor([-1e-8, Wl - 1, Wl - 0.5])
    args = [t.to(dev).contiguous() for t in (g_own, cen)] + [scale] + [
        t.to(dev).contiguous() for t in (g_cross, cx, cy)] + [Hl, Wl, dtype]
    n0 = dccl_scatter.dccl_level_scatter.launches
    got = dccl_scatter.dccl_level_scatter(*args)
    torch.cuda.synchronize()
    assert dccl_scatter.dccl_level_scatter.launches == n0 + 1
    ref = dccl_scatter.dccl_level_scatter_plain(*args)
    assert got.dtype == ref.dtype == dtype
    got, ref = got.float(), ref.float()
    # atomics sum in another order: f32 to 1e-5 of the largest value; a
    # bf16 value may round one step apart
    tol = 1e-5 * ref.abs().max() + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.abs()
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instance_norm_backward_on_card_matches_plain(dev, dtype):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 64, 32, 64, generator=g) * 3 + 1.5).to(dtype)
    dy = torch.randn(4, 64, 32, 64, generator=g).to(dtype)
    grads = []
    for d in (dev, torch.device("cpu")):
        t = x.to(d).requires_grad_()
        instance_norm.instance_norm(t).backward(dy.to(d))
        grads.append(t.grad.float().cpu())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(grads[0], grads[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("grad_mode", ["standard", "taped"])
def test_train_step_on_card_matches_cpu(dev, grad_mode):
    """One 64x128 step, batch 2, 2 iterations, f32, on the card and on the
    CPU from the same weights: loss to 1e-5 relative, every gradient tensor
    to 1e-3 relative L2, and the launch counts of the mode. Norms are
    floored at 1e-6 of the global one, and at 1e-2 of it for the fnet conv
    biases in front of an instance norm, whose exact gradient is zero."""
    g = torch.Generator().manual_seed(4)
    batch = (torch.rand(2, 64, 128, 3, generator=g) * 255,
             torch.rand(2, 64, 128, 3, generator=g) * 255,
             torch.randn(2, 64, 128, 2, generator=g) * 5,
             torch.ones(2, 64, 128))
    out = {}
    for d in (torch.device("cpu"), dev):
        model = build_model(d, seed=6)
        opt, sched = make_optimizer(model.parameters(), 1e-4, 100)
        step = make_train_step(model, opt, sched, iters=2,
                               grad_mode=grad_mode, clip=1e9)
        reset_launch_counts()
        m = step(tuple(t.to(d) for t in batch), 0)
        out[d.type] = (float(m["train/loss"]), launch_counts(),
                       {n: p.grad.detach().cpu() for n, p in
                        model.named_parameters()})
    (l_cpu, _, g_cpu), (l_gpu, counts, g_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    per = 16 if grad_mode == "standard" else 8
    want = _counts(dccl_level_lookup=8, instance_norm_sums=30,
                   dccl_level_scatter_grid=per)
    assert counts == want, counts
    total = torch.sqrt(sum((t ** 2).sum() for t in g_cpu.values()))
    for n, ref in g_cpu.items():
        zero = (n.startswith("fnet.") and n.endswith(".bias")
                and n != "fnet.conv2.bias")
        err = (g_gpu[n] - ref).norm() / max(ref.norm(),
                                            (1e-2 if zero else 1e-6) * total)
        assert err <= 1e-3, (n, float(err))


def _given_coords(dev, B, Q, Hl, Wl, seed):
    """Cross tap coords (B, Q, 81) x 4 over the plane and a margin, with
    the seam column, x a hair below 0 and the pole rows."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(2):
        x = torch.rand(B, Q, 81, generator=g) * 3 * Wl - Wl
        y = torch.rand(B, Q, 81, generator=g) * (Hl + 3) - 2
        x[0, 0, :4] = torch.tensor([-1e-8, Wl - 1, Wl - 0.5, 0.0])
        y[0, 0, :4] = torch.tensor([0.0, Hl - 1, -0.5, Hl - 0.5])
        out += [x.to(dev), y.to(dev)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_lookup_coords_kernel_is_bitwise_plain(dev, dtype, lvl):
    vA, vB, cA, cB, _, _ = _level_inputs(dev, 2, 16, 32, lvl, dtype)
    B, Q, Hl, Wl = vA.shape
    given = _given_coords(dev, B, Q, Hl, Wl, lvl)
    scale = 1.0 / 2 ** lvl
    with torch.no_grad():
        n0 = dccl_lookup.dccl_level_lookup_coords.launches
        got = dccl_lookup.dccl_level_lookup_coords(vA, vB, cA, cB, scale,
                                                   *given)
        torch.cuda.synchronize()
        assert dccl_lookup.dccl_level_lookup_coords.launches == n0 + 1
        ref = dccl_lookup.dccl_level_lookup_coords_plain(vA, vB, cA, cB,
                                                         scale, *given)
    for o, r in zip(got, ref):
        assert o.dtype == torch.float32 and torch.equal(o, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_planes_route_is_bitwise_kernel_1(dev, dtype):
    """On a 128x256 grid (a 1024x2048 input), the planes route (one coords
    launch for both branches and all levels, then the lookup at given
    coords) gives kernel 1's bits, level by level."""
    g = torch.Generator().manual_seed(2)
    Q, h, w = 2048, 128, 256           # a sample of the 32768 queries
    vols = [[torch.randn(1, Q, h >> lvl, w >> lvl, generator=g).to(dtype)
             .to(dev) for _ in range(2)] for lvl in range(4)]
    u = torch.rand(2, 2, 1, Q, generator=g)
    cA, cB = (torch.stack([t[0] * (w + 4) - 2, t[1] * (h + 4) - 2], -1)
              .to(dev).contiguous() for t in u)
    grids = rotation_grids(8 * h, 8 * w).to_device(dev)
    gA, gB = grids.a2b_w2c_8, grids.b2a_w2c_8
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    with torch.no_grad():
        planes = dccl_coords.dccl_cross_coords(cA, cB, gA, gB, scales)
        BQ = cA.shape[0] * cA.shape[1]
        for lvl, (vA, vB, *_) in enumerate(vols):
            given = [p[lvl * BQ:(lvl + 1) * BQ].reshape(*cA.shape[:2], 81)
                     for p in planes]
            got = dccl_lookup.dccl_level_lookup_coords(vA, vB, cA, cB,
                                                       scales[lvl], *given)
            ref = dccl_lookup.dccl_level_lookup(vA, vB, cA, cB, gA, gB,
                                                scales[lvl])
            for o, r in zip(got, ref):
                assert torch.equal(o, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4])
def test_all_levels_kernel_is_bitwise_per_level(dev, dtype, B):
    vols = [_level_inputs(dev, B, 16, 32, lvl, dtype, seed=lvl)
            for lvl in range(4)]
    cA, cB, gA, gB = vols[0][2:]
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    with torch.no_grad():
        n0 = dccl_lookup.dccl_lookup_all_levels.launches
        got = dccl_lookup.dccl_lookup_all_levels(
            [v[0] for v in vols], [v[1] for v in vols], cA, cB, gA, gB,
            scales)
        torch.cuda.synchronize()
        assert dccl_lookup.dccl_lookup_all_levels.launches == n0 + 1
        for lvl, (vA, vB, *_) in enumerate(vols):
            ref = dccl_lookup.dccl_level_lookup(vA, vB, cA, cB, gA, gB,
                                                scales[lvl])
            for o, r in zip(got[lvl], ref):
                assert torch.equal(o, r)


@pytest.mark.parametrize("fn", ["coords", "all_levels"])
def test_new_functions_gradient_on_card_matches_plain_autograd(dev, fn):
    """The volumes' gradients through ``DCCLLevelLookupCoords`` and
    ``DCCLAllLevelsLookup`` with one launch for all levels (kernels forward
    and backward, the coords computed inside the grid-entry scatters)
    against autograd of the plain versions on the card: f32, 1e-5 of
    max|plain| (the scatter's shared-memory atomics reorder the sums)."""
    vols = [_level_inputs(dev, 2, 16, 32, lvl, torch.float32, seed=lvl)
            for lvl in range(4)]
    cA, cB, gA, gB = vols[0][2:]
    scales = tuple(1.0 / 2 ** lvl for lvl in range(4))
    given = [_given_coords(dev, 2, 512, 16 >> lvl, 32 >> lvl, 10 + lvl)
             for lvl in range(4)]
    g = torch.Generator().manual_seed(5)
    cts = [torch.randn(2, 512, 81, generator=g).to(dev) for _ in range(16)]

    def grads(function):
        vA = [v[0].clone().requires_grad_() for v in vols]
        vB = [v[1].clone().requires_grad_() for v in vols]
        if fn == "coords":
            lookup = (corr.DCCLLevelLookupCoords.apply if function
                      else dccl_lookup.dccl_level_lookup_coords_plain)
            outs = [o for lvl in range(4) for o in lookup(
                vA[lvl], vB[lvl], cA, cB, scales[lvl], *given[lvl])]
        elif function:
            outs = corr.DCCLAllLevelsLookup.apply(
                cA, cB, gA, gB, scales, True,
                *(v for pair in zip(vA, vB) for v in pair))
            torch.autograd.backward(outs, [torch.cat(cts[j::4], -1)
                                           for j in range(4)])
            return [v.grad for v in vA + vB]
        else:
            outs = [o for lv in dccl_lookup.dccl_lookup_all_levels_plain(
                vA, vB, cA, cB, gA, gB, scales) for o in lv]
        torch.autograd.backward(outs, cts)
        return [v.grad for v in vA + vB]

    reset_launch_counts()
    got = grads(True)
    counts = launch_counts()
    ref = grads(False)
    if fn == "coords":
        assert counts["dccl_level_lookup_coords"] == 4
        assert counts["dccl_level_scatter"] == 8
    else:
        assert counts["dccl_lookup_all_levels"] == 1
        assert counts["dccl_grid_coords"] == counts["dccl_cross_coords"] == 0
        assert counts["dccl_level_scatter_grid"] == 8
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6


# -- the redesigned kernel 1 and the shared-memory scatter -------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4])
def test_kernel_1_is_bitwise_row_3_at_the_coords_kernels_coords(dev, dtype,
                                                                  B):
    """Kernel 1's column body against row 3 (the lookup at given coords,
    which keeps the one-thread-per-tap body) fed the coords kernel's
    coords, at every level of a 128x256 input (64x128 planes at level 0,
    a 512x1024 forward's): bitwise, so the column body gives the old bits.
    Also written into columns of wider arrays: the same bits."""
    for lvl in range(4):
        vA, vB, cA, cB, gA, gB = _level_inputs(dev, B, 16, 32, lvl, dtype,
                                               seed=lvl)
        s = 1.0 / 2 ** lvl
        with torch.no_grad():
            given = [c.reshape(*cA.shape[:2], 81) for cen, grid in
                     ((cA, gA), (cB, gB))
                     for c in dccl_coords.dccl_grid_coords(
                         cen.reshape(-1, 2), grid, s)]
            got = dccl_lookup.dccl_level_lookup(vA, vB, cA, cB, gA, gB, s)
            ref = dccl_lookup.dccl_level_lookup_coords(vA, vB, cA, cB, s,
                                                       *given)
            out = [torch.zeros(*cA.shape[:2], 3 * 81, device=dev)
                   for _ in range(4)]
            cols = dccl_lookup.dccl_level_lookup(vA, vB, cA, cB, gA, gB, s,
                                                 out=out, col=162)
            torch.cuda.synchronize()
        for o, r, c in zip(got, ref, cols):
            assert torch.equal(o, r) and torch.equal(c, r)
        assert all(bool((o[..., :162] == 0).all()) for o in out)


def _scatter_case(dev, S, B, Q, Hl, Wl, seed):
    g = torch.Generator().manual_seed(seed)
    g_own = torch.randn(S, B, Q, 81, generator=g)
    g_cross = torch.randn(S, B, Q, 81, generator=g)
    cen, other = (torch.stack(
        [torch.rand(S, B, Q, generator=g) * (2 * Wl + 8) - 4,
         torch.rand(S, B, Q, generator=g) * (2 * Hl + 8) - 4], -1)
        for _ in range(2))
    other[0, 0, :3] = torch.tensor([[-1e-8, 1.0], [Wl - 1, 0.0],
                                    [Wl - 0.5, Hl - 1]])
    return [t.to(dev).contiguous() for t in (g_own, cen, g_cross, other)]


def _close_to_plain(got, ref, dtype):
    """Shared-memory atomics sum in another order: f32 to 1e-5 of the
    largest value; a bf16 value may round one step apart."""
    assert got.dtype == ref.dtype == dtype
    got, ref = got.float(), ref.float()
    tol = 1e-5 * ref.abs().max() + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.abs()
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 3])
def test_scatter_grid_entry_matches_plain_and_the_given_coords_entry(
        dev, dtype, S):
    """The grid entry against its plain version, and against the
    given-coords entry fed the coords kernel's coords, from a level slice
    of wider cotangents."""
    Hl, Wl, scale = 16, 32, 0.5
    g_own, cen, g_cross, other = _scatter_case(dev, S, 2, 64, Hl, Wl, S)
    grid = rotation_grids(128, 256).to_device(dev).b2a_w2c_8
    wide = torch.zeros(2, S, 2, 64, 3 * 81, device=dev)
    wide[0, ..., 81:162], wide[1, ..., 81:162] = g_own, g_cross
    n0 = dccl_scatter.dccl_level_scatter_grid.launches
    got = dccl_scatter.dccl_level_scatter_grid(
        wide[0, ..., 81:162], cen, wide[1, ..., 81:162], other, grid, scale,
        Hl, Wl, dtype)
    torch.cuda.synchronize()
    assert dccl_scatter.dccl_level_scatter_grid.launches == n0 + 1
    ref = dccl_scatter.dccl_level_scatter_grid_plain(
        g_own, cen, g_cross, other, grid, scale, Hl, Wl, dtype)
    _close_to_plain(got, ref, dtype)
    cx, cy = (c.reshape(g_own.shape) for c in dccl_coords.dccl_grid_coords(
        other.reshape(-1, 2), grid, scale))
    given = dccl_scatter.dccl_level_scatter(g_own, cen, scale, g_cross, cx,
                                            cy, Hl, Wl, dtype)
    _close_to_plain(got, given, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_plane_above_the_shared_memory_budget(dev, dtype):
    """A 128x256 f32 plane (128 KB, level 0 of a 1024x2048 input) is
    summed in row bands; both entries against their plain versions."""
    Hl, Wl, scale = 128, 256, 1.0
    g_own, cen, g_cross, other = _scatter_case(dev, 2, 1, 48, Hl, Wl, 7)
    grid = rotation_grids(1024, 2048).to_device(dev).a2b_w2c_8
    got = dccl_scatter.dccl_level_scatter_grid(g_own, cen, g_cross, other,
                                               grid, scale, Hl, Wl, dtype)
    ref = dccl_scatter.dccl_level_scatter_grid_plain(
        g_own, cen, g_cross, other, grid, scale, Hl, Wl, dtype)
    _close_to_plain(got, ref, dtype)
    cx = other[..., :1].expand(g_own.shape) + torch.arange(
        81, device=dev) * 3.0 - 120.0
    cy = other[..., 1:].expand(g_own.shape) * 0.5 + torch.arange(
        81, device=dev) * 1.5
    cx, cy = cx.contiguous(), cy.contiguous()
    got = dccl_scatter.dccl_level_scatter(g_own, cen, scale, g_cross, cx, cy,
                                          Hl, Wl, dtype)
    ref = dccl_scatter.dccl_level_scatter_plain(g_own, cen, scale, g_cross, cx,
                                                cy, Hl, Wl, dtype)
    _close_to_plain(got, ref, dtype)


def test_scatter_refuses_bad_inputs(dev):
    g_own, cen, g_cross, other = _scatter_case(dev, 1, 1, 8, 4, 8, 1)
    grid = rotation_grids(32, 64).to_device(dev).a2b_w2c_8
    entry = dccl_scatter.dccl_level_scatter_grid
    with pytest.raises(ValueError):   # a column stride of 2
        entry(torch.zeros(1, 1, 8, 162, device=dev)[..., ::2], cen, g_cross,
              other, grid, 1.0, 4, 8)
    with pytest.raises(ValueError):
        entry(g_own, cen[..., :1], g_cross, other, grid, 1.0, 4, 8)
    with pytest.raises(TypeError):
        entry(g_own, cen, g_cross, other, grid, 1.0, 4, 8, torch.float16)


# -- the measurement tools' kernels ------------------------------------------------

def _anchor_inputs(dev, rows=64):
    """x and a permutation idx per row, but rows 3 and 5: random int32 (any
    sign, duplicates) and a constant."""
    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, 128, generator=g)
    idx = torch.argsort(torch.rand(rows, 128, generator=g), dim=1)
    idx[3] = torch.randint(-2 ** 31, 2 ** 31 - 1, (128,), generator=g)
    idx[5] = 77
    return x.to(dev), idx.to(torch.int32).to(dev)


def test_gather_plan_matches_plain(dev):
    """The plan kernel bitwise its plain version, permutation rows and
    others, 75 rows (one full block of its 64 threads and a partial one of
    11)."""
    _, idx = _anchor_inputs(dev, 75)
    n0 = anchors.gather_plan.launches
    got = anchors.gather_plan(idx)
    torch.cuda.synchronize()
    assert anchors.gather_plan.launches == n0 + 1
    assert torch.equal(got, anchors.gather_plan_plain(idx))


@pytest.mark.parametrize("ilp", [1, 4])
@pytest.mark.parametrize("kind", ["select", "gather", "fma"])
def test_anchor_chain_matches_plain(dev, kind, ilp):
    """K = 256 on 75 rows (a partial last block of 3 of its 8 rows), two of
    them no permutation, bitwise: the plain fma step rounds once, as the
    FFMA does; the gather on the plan it builds and on one given."""
    from prior_flow_tpu_torch.tools.microbench_vpu_anchor import ulps_apart
    x, idx = _anchor_inputs(dev, 75)
    n0 = anchors.anchor_chain.launches
    got = anchors.anchor_chain(x, idx, kind, ilp)
    torch.cuda.synchronize()
    assert anchors.anchor_chain.launches == n0 + 1
    ref = anchors.anchor_chain_plain(x, idx, kind, ilp)
    assert ulps_apart(got, ref) == 0
    if kind == "gather":
        plan = anchors.gather_plan_plain(idx)
        assert ulps_apart(anchors.anchor_chain(x, idx, kind, ilp,
                                               plan=plan), ref) == 0


def test_anchor_chain_sass_keeps_every_step(dev):
    """The built library's chain kernels hold K step instructions per
    element, less at most one per chain: no chain was folded."""
    from prior_flow_tpu_torch.tools import microbench_vpu_anchor as va
    counts = va.sass_counts()
    for kind in va.KINDS:
        for ilp in (1, 4):
            assert va.chain_intact(counts, kind, ilp), \
                (kind, ilp, counts[kind, ilp])


def test_step_cost_copy_and_empty_launch(dev):
    x = torch.randn(40 * 8, 128, device=dev)
    assert torch.equal(anchors.step_cost_copy(x), 2 * x)
    anchors.launch_empty(dev)
    torch.cuda.synchronize()


def test_anchor_wrappers_refuse_bad_inputs(dev):
    x, idx = _anchor_inputs(dev)
    with pytest.raises(ValueError):
        anchors.anchor_chain(x, idx, "fma", 1, K=16)
    with pytest.raises(ValueError):
        anchors.anchor_chain(x, idx.long(), "select")
    with pytest.raises(ValueError):
        anchors.anchor_chain(x[:, :64], idx[:, :64], "select")
    with pytest.raises(ValueError):
        anchors.step_cost_copy(x[:12])
    with pytest.raises(ValueError):
        anchors.anchor_chain(x, idx, "gather", plan=anchors.gather_plan(
            idx)[:-1])
    with pytest.raises(ValueError):
        anchors.gather_plan(idx[:, :64].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
def test_dccl_stages_are_kernel_1_and_coords_kernel(dev, dtype, lvl):
    """Own-only and cross-only bitwise kernel 1's own and cross outputs,
    gridwin-only bitwise two coords-kernel launches, each within
    LOOKUP_ATOL of its plain version."""
    from prior_flow_tpu_torch.tools import microbench_kernel_split as ks
    ins, s = ks.level_inputs(dev, dtype, lvl, size=(128, 256))
    reset_launch_counts()
    errs = ks.gate(ins, s)
    counts = launch_counts()
    assert counts["dccl_own_only"] == counts["dccl_gridwin_only"] == \
        counts["dccl_cross_only"] == 1
    assert max(errs.values()) <= LOOKUP_ATOL


def test_dccl_stage_refuses_bad_inputs(dev):
    vA, vB, cA, cB, gA, gB = _level_inputs(dev, 1, 8, 16, 0, torch.float32)
    with pytest.raises(TypeError):
        dccl_stages.dccl_own_only(vA.half(), vB.half(), cA, cB, gA, gB, 1.0)
    with pytest.raises(ValueError):
        dccl_stages.dccl_cross_only(vA, vB, cA[:, :-1], cB, gA, gB, 1.0)
    with pytest.raises(ValueError):
        dccl_stages.dccl_gridwin_only(vA, vB, cA, cB, gA[:, :, :1], gB, 1.0)


@pytest.mark.parametrize("size", [(64, 128), (512, 1024)])
def test_gridwin_variants_and_pair_are_the_coords_kernel(dev, size):
    """Every semantic variant and the pair bitwise equal to two
    coords-kernel launches, these to their plain version, and the
    diagnostics to theirs; the diagnostics give finite values."""
    from prior_flow_tpu_torch.tools import microbench_gridwin as gw
    ins = gw.inputs(dev, size=size)
    reset_launch_counts()
    gw.gate(*ins)
    assert launch_counts()["gridwin_variant"] == \
        len(gridwin_variants.VARIANTS) + len(gridwin_variants.DIAGNOSTICS)
    assert launch_counts()["gridwin_pair"] == 1
    for v in gridwin_variants.DIAGNOSTICS:
        outs = gridwin_variants.gridwin_variant(ins[0], ins[2], ins[3], 0.5, v)
        assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_gridwin_refuses_bad_inputs(dev):
    from prior_flow_tpu_torch.tools import microbench_gridwin as gw
    cen, cenB, gA, gB = gw.inputs(dev, size=(64, 128))
    big = torch.zeros(128, 256, 2, device=dev)   # two grids > 227 KB
    with pytest.raises(ValueError):
        gridwin_variants.gridwin_variant(cen, big, big, 1.0, "smem_grid")
    with pytest.raises(ValueError):
        gridwin_variants.gridwin_variant(cen, gA, gB, 1.0, "preblend")
    with pytest.raises(ValueError):
        gridwin_variants.gridwin_pair(cen, cenB[:-1], gA, gB, 1.0)
    with pytest.raises(ValueError):
        gridwin_variants.gridwin_pair(cen, cenB, gA.double(), gB, 1.0)
    # the same grids at 1024x2048 fit the direct variant
    outs = gridwin_variants.gridwin_variant(cen, big, big, 1.0, "direct")
    assert outs[0].shape == (cen.shape[0], 81)
    # grids that fit alone but not beside smem_grid's output stage
    mid = torch.zeros(96, 128, 2, device=dev)
    assert 2 * mid.numel() * 4 <= gridwin_variants.SMEM_BYTES
    with pytest.raises(ValueError):
        gridwin_variants.gridwin_variant(cen, mid, mid, 1.0, "smem_grid")


@pytest.mark.parametrize("shape,offset", [((33, 65), 0), ((33, 64), 1)])
def test_gridwin_smem_grid_odd_and_unaligned_grids(dev, shape, offset):
    """smem_grid on grids of an odd cell count (33x65) and on grids that
    start one cell past a 16-byte boundary: bitwise the plain version and
    direct, at 1000 centres (not a whole number of 32-centre steps)."""
    g = torch.Generator().manual_seed(offset)
    cells = shape[0] * shape[1] * 2
    store = torch.randn(2, cells + 2, generator=g).to(dev)
    gA, gB = (s[2 * offset:2 * offset + cells].view(*shape, 2)
              for s in store)
    cen = (torch.rand(1000, 2, generator=g) * torch.tensor([80.0, 40.0])
           - 5).to(dev)
    got = gridwin_variants.gridwin_variant(cen, gA, gB, 0.5, "smem_grid")
    want = gridwin_variants.gridwin_variant_plain(cen, gA, gB, 0.5)
    direct = gridwin_variants.gridwin_variant(cen, gA, gB, 0.5, "direct")
    for a, b, c in zip(got, want, direct):
        assert torch.equal(a, b) and torch.equal(a, c)


def _mpf_tree(root, h, w, frames=3, seed=0):
    """A seeded MPF test split (``EFTs_Car100``) written by the port's own
    writers: ``frames`` PNG frames and their ``.flo`` ground truth."""
    import os

    import numpy as np

    from prior_flow_tpu_torch.data import frame_utils
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "EFTs_Car100")
    os.makedirs(os.path.join(d, "image"))
    os.makedirs(os.path.join(d, "flow"))
    for i in range(frames):
        frame_utils.write_image(os.path.join(d, "image", f"{i:04d}.png"),
                                rng.integers(0, 256, (h, w, 3), np.uint8))
        frame_utils.write_flo(os.path.join(d, "flow", f"{i:04d}.flo"),
                              (rng.normal(size=(h, w, 2)) * 4).astype(
                                  np.float32))
    return str(root)


@pytest.mark.parametrize("regions", [False, True])
def test_eval_loop_on_card_matches_cpu(dev, tmp_path, regions):
    """The MPF validators on the card against the CPU at 128x256, 4
    iterations, 2 pairs, each metric to a relative 1e-3 (chip_smoke.py
    phase 18's gate)."""
    from prior_flow_tpu_torch.eval import evaluate as V
    root = _mpf_tree(tmp_path, 128, 256)
    fn = V.validate_mpf_regions if regions else V.validate_mpf
    card = fn(build_model(dev, seed=3, precision="highest"), iters=4,
              data_root=root)
    cpu = fn(build_model("cpu", seed=3), iters=4, data_root=root)

    def flat(res):
        return {f"{k}-{m}": x for k, v in res.items()
                for m, x in (v.items() if isinstance(v, dict) else [("", v)])}

    got, ref = flat(card), flat(cpu)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3 * abs(ref[k]), (k, got[k], ref[k])


def test_eval_loop_launch_counts(dev, tmp_path):
    """The evaluation loop launches kernel 1 four times per iteration and
    the sums 15 times per pair, and nothing else: no plain route."""
    from prior_flow_tpu_torch.eval import evaluate as V
    root = _mpf_tree(tmp_path, 64, 128, frames=3)
    model = build_model(dev, seed=0, precision="highest")
    V.validate_mpf(model, iters=2, data_root=root, max_samples=1)
    torch.cuda.synchronize()
    reset_launch_counts()
    V.validate_mpf(model, iters=2, data_root=root)
    torch.cuda.synchronize()
    assert launch_counts() == _counts(dccl_level_lookup=2 * 4 * 2,
                                      instance_norm_sums=2 * 15)


# -- the serving path: the priorflow:: ops and the AOTInductor package ---------

@pytest.mark.parametrize("case", ["lookup_levels", "lookup_levels_fused",
                                  "lookup_coords", "cross_coords", "sums"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_opcheck_on_card(dev, case, dtype):
    """``torch.library.opcheck`` of each priorflow:: op on CUDA tensors
    (schema, fake implementation, dynamic shapes against the kernel)."""
    from prior_flow_tpu_torch.ops.kernels import library
    h, w = 16, 32
    scales = [1.0 / 2 ** lvl for lvl in range(4)]
    levels = [_level_inputs(dev, 1, h, w, lvl, dtype) for lvl in range(4)]
    vA, vB = [lv[0] for lv in levels], [lv[1] for lv in levels]
    cA, cB, gA, gB = levels[0][2:]
    if case.startswith("lookup_levels"):
        op, args = library.dccl_lookup_levels, (
            vA, vB, cA, cB, gA, gB, scales, case.endswith("fused"))
    elif case == "lookup_coords":
        xy = [c.reshape(1, -1, 81)
              for c in library.dccl_cross_coords(cA, cB, gA, gB, [1.0])]
        op, args = library.dccl_level_lookup_coords, (vA[0], vB[0], cA, cB,
                                                      1.0, *xy)
    elif case == "cross_coords":
        op, args = library.dccl_cross_coords, (cA, cB, gA, gB, scales)
    else:
        x = torch.randn(4, 8, 16, 32, device=dev).to(dtype)
        op, args = library.instance_norm_sums, (x, x)
    torch.library.opcheck(op, args)
    torch.cuda.synchronize()


def test_aot_package_runs_the_kernels_on_card(dev, tmp_path):
    """The AOTInductor package, loaded from its file alone, launches kernel
    1 four times per iteration and the sums 15 times per call and nothing
    else, and refuses an image of another batch or device. Called with
    TF32 on for cuDNN (torch's default), it lies within 1e-3 x flow scale
    of eager and below half the distance TF32 convolutions put eager from
    itself: it runs under its recorded precision ("highest")."""
    from prior_flow_tpu_torch import serving
    from prior_flow_tpu_torch.serving.export import CompiledForward
    model = build_model(dev, seed=0, precision="highest")
    state = model.state_dict()
    g = torch.Generator().manual_seed(0)
    i1, i2 = (torch.rand(1, 64, 128, 3, generator=g).mul(255).to(dev)
              for _ in range(2))
    path = str(tmp_path / "m.pt2")
    serving.aot_compile(model, state, (1, 64, 128), 2, package_path=path)
    compiled = CompiledForward(path)
    want = model(i1, i2, iters=2)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = build_model(dev, seed=0)(i1, i2, iters=2)
        compiled(state, i1, i2)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = compiled(state, i1, i2)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    assert launch_counts() == _counts(dccl_level_lookup=8,
                                      instance_norm_sums=15)
    scale = want.abs().max()
    d_tf32 = (tf32 - want).abs().max() / scale
    err = (got - want).abs().max() / scale
    print(f"package {err:.3e} x flow scale from eager; TF32 eager "
          f"{d_tf32:.3e}")
    assert err <= 1e-3 and err < 0.5 * d_tf32
    for bad in (torch.cat([i1, i1]), i1.cpu()):
        with pytest.raises(ValueError):
            compiled(state, bad, bad)
