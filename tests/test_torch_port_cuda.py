"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it runs as it is on a machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import pytest
import torch

from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.models import build_model
from prior_flow_tpu_torch.ops.kernels import (dccl_lookup, instance_norm,
                                              launch_counts,
                                              reset_launch_counts)

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
                               "instance_norm_sums": 15}
    err = (out.cpu() - ref).abs().max().item()
    assert err <= 1e-3 * ref.abs().max().item(), err
