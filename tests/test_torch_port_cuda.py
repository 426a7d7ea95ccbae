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
from prior_flow_tpu_torch.ops.kernels import (dccl_coords, dccl_lookup,
                                              dccl_scatter, instance_norm,
                                              launch_counts,
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
    assert launch_counts() == {"dccl_level_lookup": 4 * iters,
                               "instance_norm_sums": 15,
                               "dccl_grid_coords": 0, "dccl_level_scatter": 0,
                               "dccl_level_lookup_coords": 0,
                               "dccl_lookup_all_levels": 0}
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
    want = {"dccl_level_lookup": 8, "instance_norm_sums": 30,
            "dccl_grid_coords": 16 if grad_mode == "standard" else 8,
            "dccl_level_scatter": 16 if grad_mode == "standard" else 8,
            "dccl_level_lookup_coords": 0, "dccl_lookup_all_levels": 0}
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
    launch per branch for all levels, then the lookup at given coords)
    gives kernel 1's bits, level by level."""
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
        planes = (*corr.cross_coords_all_levels(cA, gA, scales),
                  *corr.cross_coords_all_levels(cB, gB, scales))
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
    ``DCCLAllLevelsLookup`` (kernels forward and backward) against autograd
    of the plain versions on the card: f32, 1e-5 of max|plain| (the
    scatter's atomics reorder the sums)."""
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
                cA, cB, gA, gB, scales,
                *(v for pair in zip(vA, vB) for v in pair))
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
        assert counts["dccl_grid_coords"] == 8
        assert counts["dccl_level_scatter"] == 8
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item() + 1e-6
