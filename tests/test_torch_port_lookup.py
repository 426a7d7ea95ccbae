"""The lookup modes of the port (``PriOrRAFT(lookup_mode=...)``,
``ops.corr.DCCL`` with ``mxu`` and ``gather``) against the JAX package on
the CPU, and the multi-platform export they allow.

Tolerances:
- ``DCCL`` against JAX's ``DCCL`` on unit-scale volumes: f32 own taps
  1e-5 abs (both blend the same corners, the sums in another order);
  cross taps 1e-4 abs, for the window-coords rounding of ROADMAP Queue 3
  (as test_torch_port_scale.py's); bf16 volumes 1e-2 of max|field| (one
  bf16 step of the rounded first contraction);
- the mxu and gather models against the kernel route: JAX's forward
  contract, 1e-4 x flow scale + 1e-4 (``tests/test_model.py:100-115``);
- the exported program against eager: 1e-5 abs
  (``tests/test_serving.py``'s bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.ops import corr as jcorr
from prior_flow_tpu_torch import serving
from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.models import PriOrRAFT, build_model
from prior_flow_tpu_torch.ops import corr
from prior_flow_tpu_torch.ops.kernels import launch_counts
from prior_flow_tpu_torch.train import make_optimizer, make_train_step
from test_torch_port_ops import _centres

OWN_ATOL, CROSS_ATOL = 1e-5, 1e-4
BF16_RTOL = 1e-2
FLOW_RTOL = FLOW_ATOL = 1e-4
EXPORT_ATOL = 1e-5
MODES = ["mxu", "gather"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``test_torch_port_scale.py``: the suite's
    worker processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pyramids(rng, B, h, w, C=32):
    f = [torch.from_numpy(rng.normal(size=(B, h, w, C)).astype(np.float32))
         for _ in range(4)]
    return (corr.build_pyramid(corr.all_pairs_correlation(f[0], f[1])),
            corr.build_pyramid(corr.all_pairs_correlation(f[2], f[3])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", MODES)
def test_dccl_matches_jax(mode, dtype):
    """``DCCL`` per branch against JAX's at an 8x16 grid (the real 64x128
    rotation grids), 4 levels, centres over the image, its margin, the
    seam and the pole rows."""
    rng = np.random.default_rng(3)
    B, h, w = 2, 8, 16
    pyr_A, pyr_B = _pyramids(rng, B, h, w)
    pyr_A = [p.to(dtype) for p in pyr_A]
    pyr_B = [p.to(dtype) for p in pyr_B]
    cens = [_centres(rng, B * h * w, h, w).reshape(B, h, w, 2)
            for _ in range(2)]
    tg = rotation_grids(8 * h, 8 * w).to_device("cpu")
    d = corr.DCCL(4, 4, lookup_mode=mode)
    got = [*d(torch.from_numpy(cens[0]), pyr_A, pyr_B, tg.a2b_w2c_8,
              tg.b2a_8),
           *d(torch.from_numpy(cens[1]), pyr_B, pyr_A, tg.b2a_w2c_8,
              tg.a2b_8)]

    g = jgrids.rotation_grids(8 * h, 8 * w)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jd = jcorr.DCCL(4, 4, lookup_mode=mode)

    @jax.jit
    def ref_fn(cA, cB, jA, jB):
        return (*jd(cA, jA, jB, g.a2b_w2c_8, g.b2a_8),
                *jd(cB, jB, jA, g.b2a_w2c_8, g.a2b_8))

    ref = ref_fn(*(jnp.asarray(c) for c in cens),
                 [jnp.asarray(p.float().numpy()).astype(jdt) for p in pyr_A],
                 [jnp.asarray(p.float().numpy()).astype(jdt) for p in pyr_B])
    for name, a, b, tol in zip(("own_A", "cross_A", "own_B", "cross_B"),
                               got, ref, (OWN_ATOL, CROSS_ATOL) * 2):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float32 and a.shape == b.shape == (B, h, w,
                                                                4 * 81)
        scale = float(np.abs(b).max())
        if dtype == torch.bfloat16:
            tol = BF16_RTOL * scale
        err = float(np.abs(a - b).max())
        print(f"{mode} {dtype} {name}: max abs err {err:.3e} (max |ref| "
              f"{scale:.3f}, gate {tol:.3e})")
        assert err <= tol, name


def test_volume_level_mxu_chunks_taps(monkeypatch):
    """The adaptive tap chunking of ``sample_volume_level_mxu`` gives the
    unchunked values, and both the gather sampler's (1e-6 abs: f32 sums of
    8 terms in another order)."""
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.normal(size=(1, 6, 4, 8)).astype(np.float32))
    c = torch.from_numpy(np.stack([rng.uniform(-3, 11, (1, 6, 81)),
                                   rng.uniform(-2, 5, (1, 6, 81))],
                                  -1).astype(np.float32))
    whole = corr.sample_volume_level_mxu(vol, c)
    monkeypatch.setattr(corr, "MXU_TAP_BUDGET", 4 * 6 * 4 * 10)
    chunked = corr.sample_volume_level_mxu(vol, c)
    plain = corr.sample_volume_level(vol, c)
    for got in (whole, chunked):
        torch.testing.assert_close(got, plain, atol=1e-6, rtol=0)


def _pair(seed, H, W):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand(1, H, W, 3, generator=g) * 255 for _ in range(2)]


@pytest.mark.parametrize("mode", MODES)
def test_model_modes_match_the_kernel_route(mode):
    """``PriOrRAFT(lookup_mode=mode)`` against the kernel route (``auto``)
    at 64x128, 2 iterations, at JAX's forward contract; no lookup kernel
    launches (none would on the CPU either) and ``pallas`` is ``auto``."""
    i1, i2 = _pair(1, 64, 128)
    ref = build_model("cpu", seed=0, precision="highest")(i1, i2, iters=2)
    model = build_model("cpu", seed=0, precision="highest", lookup_mode=mode)
    assert isinstance(model.dccl, corr.DCCL) and \
        model.dccl.lookup_mode == mode
    got = model(i1, i2, iters=2)
    err = float((got - ref).abs().max())
    bound = FLOW_RTOL * float(ref.abs().max()) + FLOW_ATOL
    print(f"{mode}: max abs err {err:.3e} (gate {bound:.3e})")
    assert err <= bound
    assert isinstance(PriOrRAFT(lookup_mode="pallas").dccl, corr.DCCLFused)


def test_lookup_mode_resolution_and_refusals():
    """On-the-fly wins over every lookup mode (as in JAX); unknown modes
    raise; the taped mode refuses mxu and gather, whose lookups have no
    recording; the standard step trains with them."""
    for mode in ("auto", "mxu", "gather"):
        m = PriOrRAFT(lookup_mode=mode, corr_mode="onthefly")
        assert isinstance(m.dccl, corr.DCCLOnTheFly)
    with pytest.raises(ValueError, match="lookup_mode"):
        PriOrRAFT(lookup_mode="xla")
    with pytest.raises(ValueError, match="lookup_mode"):
        corr.DCCL(lookup_mode="pallas")
    g = torch.Generator().manual_seed(2)
    batch = (torch.rand(1, 64, 128, 3, generator=g) * 255,
             torch.rand(1, 64, 128, 3, generator=g) * 255,
             torch.randn(1, 64, 128, 2, generator=g),
             torch.ones(1, 64, 128))
    for grad_mode in ("taped", "standard"):
        model = build_model("cpu", seed=0, lookup_mode="mxu").train()
        opt, sched = make_optimizer(model.parameters(), 1e-4, 10)
        step = make_train_step(model, opt, sched, iters=1,
                               grad_mode=grad_mode)
        if grad_mode == "taped":
            with pytest.raises(ValueError, match="kernel lookup"):
                step(batch, 0)
        else:
            m = step(batch, 0)
            assert np.isfinite(float(m["train/loss"]))
            assert float(m["train/grad_norm"]) > 0


def test_mxu_export_lists_and_runs_its_platforms(tmp_path):
    """A 2-platform ``mxu`` program at 32x64 (one iteration: tracing and
    saving the one-hot lookups take ~10 s an iteration here): exported on
    the CPU for ("cuda", "cpu"), saved, loaded and run on the CPU within
    1e-5 of eager, no kernel launched; its summary lists both platforms;
    a device type not listed raises. The export CLI's ``--lookup_mode
    mxu`` is ``test_torch_port_serving.py::test_export_cli_refusals``'s."""
    H, W, iters = 32, 64, 1
    model = build_model("cpu", seed=0, precision="highest", lookup_mode="mxu")
    state = model.state_dict()
    exported = serving.export_forward(model, state, (1, H, W), iters,
                                      platforms=["cuda", "cpu"], device="cpu")
    assert serving.exported_summary(exported)["platforms"] == ["cpu", "cuda"]
    path = str(tmp_path / "mxu.pt2")
    serving.save_exported(exported, path)
    fn = serving.load_exported(path)
    i1, i2 = _pair(4, H, W)
    before = launch_counts()
    got = fn(state, i1, i2)
    assert launch_counts() == before
    want = serving.make_forward(model, iters)(state, i1, i2)
    err = float((got - want).abs().max())
    print(f"program against eager: max abs err {err:.3e}")
    assert err <= EXPORT_ATOL
    assert serving.exported_summary(fn.exported)["platforms"] == ["cpu",
                                                                  "cuda"]
    with pytest.raises(ValueError, match="runs on"):
        fn(state, *(t.to("meta") for t in (i1, i2)))
