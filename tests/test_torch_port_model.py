"""The port's test-mode PriOr-RAFT forward against the JAX model on the
CPU, through each of its routes (the default; the chunked pyramid build
with the lookup at given cross coords, as at 1024x2048; all levels in one
lookup call), plus the weight bridge, the demo CLI and import hygiene."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from prior_flow_tpu.checkpoint.convert import export_state_dict
from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
from prior_flow_tpu.models.prior_raft import \
    upsample_flow_convex as jax_upsample
from prior_flow_tpu_torch.checkpoint import (load_pth, state_dict_from_jax,
                                             strip_module_prefix)
from prior_flow_tpu_torch.models import PriOrRAFT, build_model, prior_raft
from prior_flow_tpu_torch.ops.corr import DCCLFused
from prior_flow_tpu_torch.models.prior_raft import upsample_flow_convex
from test_torch_port_nn import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_TOL = 1e-3  # max abs error allowed, as a fraction of the flow scale


def _pair(seed, H, W, B=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
                 for _ in range(2))


@pytest.fixture(scope="module")
def models():
    jm = JaxPriOrRAFT(precision="highest")
    img = jnp.zeros((1, 64, 128, 3))
    variables = random_variables(jm, img, img, iters=1)
    tm = build_model("cpu", state_dict=state_dict_from_jax(variables))
    return jm, variables, tm


def _compare(jm, variables, tm, H, W, iters, init_flow=None, seed=1, B=1):
    i1, i2 = _pair(seed, H, W, B)
    kw = {} if init_flow is None else {"init_flow": jnp.asarray(init_flow)}
    ref = np.asarray(jm.apply(variables, jnp.asarray(i1), jnp.asarray(i2),
                              iters=iters, test_mode=True, **kw))
    tkw = {} if init_flow is None else {"init_flow": torch.from_numpy(init_flow)}
    got = tm(torch.from_numpy(i1), torch.from_numpy(i2), iters=iters,
             **tkw).numpy()
    assert got.shape == ref.shape == (B, H, W, 2)
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    print(f"{B}x{H}x{W} iters={iters} init_flow={init_flow is not None}: "
          f"max abs err {err:.3e}, flow scale {scale:.3f}, "
          f"ratio {err / scale:.3e}")
    assert err <= FLOW_TOL * scale


def _force_route(monkeypatch, tm, route):
    """Put the module-scoped model on one of the port's routes for this
    test: "planes_lean" builds the pyramids in query chunks (the threshold
    lowered to 0) and looks up at given cross coords, as at 1024x2048;
    "fused_levels" runs all levels in one lookup call. Returns the calls
    of ``build_pyramid_lean`` seen."""
    calls = []
    lean = prior_raft.build_pyramid_lean

    def spy(*a, **k):
        calls.append(a[0].shape)
        return lean(*a, **k)

    monkeypatch.setattr(prior_raft, "build_pyramid_lean", spy)
    if route == "planes_lean":
        monkeypatch.setattr(prior_raft, "LEAN_BUILD_QUERIES", 0)
        monkeypatch.setattr(tm, "dccl", DCCLFused(grid_in_kernel=False))
    elif route == "fused_levels":
        monkeypatch.setattr(tm, "dccl", DCCLFused(fuse_levels=True))
    return calls


_ROUTES = [("default", False, "False"), ("default", True, "True"),
           ("planes_lean", False, "planes_lean-False"),
           ("planes_lean", True, "planes_lean-True"),
           ("fused_levels", False, "fused_levels-False"),
           ("fused_levels", True, "fused_levels-True")]


@pytest.mark.parametrize("precision,route,with_init", [
    pytest.param(p, r, i, id=name if p else f"None-{name}")
    for p in ("highest", None) for r, i, name in _ROUTES])
def test_forward_matches_jax(models, monkeypatch, precision, route,
                             with_init):
    """64x128, 4 iterations, f32 against the JAX PriOrRAFT built with the
    same ``precision`` (None: the backend default; 'highest': full f32),
    through each of the port's routes (JAX takes its default one)."""
    jm, variables, tm = models
    jm = jm.clone(precision=precision)
    monkeypatch.setattr(tm, "precision", precision)
    lean_calls = _force_route(monkeypatch, tm, route)
    init = None
    if with_init:
        init = np.random.default_rng(7).normal(0, 1.5, (1, 8, 16, 2)).astype(
            np.float32)
    _compare(jm, variables, tm, 64, 128, 4, init)
    assert len(lean_calls) == (2 if route == "planes_lean" else 0)


def test_precision_restores_the_callers_tf32_flags(monkeypatch):
    """``precision='highest'`` turns TF32 off for matmuls and cuDNN
    convolutions inside the forward and around a training step's forward
    and backward, and puts back the flags the caller had set, through
    either of torch's APIs; None touches nothing; any other value
    raises."""
    from prior_flow_tpu_torch.train import make_optimizer, make_train_step
    from prior_flow_tpu_torch.train import trainer
    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    seen = []

    def flags(*_):
        seen.append((mm.fp32_precision, conv.fp32_precision))
        return torch.zeros(1), torch.zeros(1)

    tm = PriOrRAFT(precision="highest")
    monkeypatch.setattr(tm, "_forward", flags)
    monkeypatch.setattr(trainer, "dual_loss", lambda *a: (
        flags()[0].sum().requires_grad_(), {}))
    step = make_train_step(tm, *make_optimizer(tm.parameters(), 1e-4, 10),
                           iters=1)
    img = torch.zeros(1, 64, 128, 3)
    batch = (img, img, torch.zeros(1, 64, 128, 2), torch.ones(1, 64, 128))
    saved = (mm.fp32_precision, conv.fp32_precision)
    try:
        for legacy in (True, False):     # torch.backends.*.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = legacy
            torch.backends.cudnn.allow_tf32 = legacy
            tm(img, img, iters=1)
            step(batch, 0)
            assert seen == [("ieee", "ieee")] * 3     # forward, step, loss
            seen.clear()
            assert torch.backends.cuda.matmul.allow_tf32 is legacy
            assert torch.backends.cudnn.allow_tf32 is legacy
        mm.fp32_precision, conv.fp32_precision = "tf32", "tf32"
        with prior_raft.precision_scope("highest"):
            assert (mm.fp32_precision, conv.fp32_precision) == ("ieee",
                                                                "ieee")
        assert (mm.fp32_precision, conv.fp32_precision) == ("tf32", "tf32")
        with prior_raft.precision_scope(None):
            assert (mm.fp32_precision, conv.fp32_precision) == ("tf32",
                                                                "tf32")
    finally:
        mm.fp32_precision, conv.fp32_precision = saved
    for bad in ("high", "float32", "fastest"):
        with pytest.raises(ValueError):
            PriOrRAFT(precision=bad)
        with pytest.raises(ValueError):
            with prior_raft.precision_scope(bad):
                pass


def test_lean_build_routing(monkeypatch):
    """The pyramids are built in query chunks exactly above
    LEAN_BUILD_QUERIES (16384, as in JAX: 1024x2048 has 32768 queries,
    512x1024 8192), and both builds give the same bits."""
    assert prior_raft.LEAN_BUILD_QUERIES == 16384
    tm = PriOrRAFT()
    g = torch.Generator().manual_seed(0)
    fmaps = tuple(torch.randn(1, 8, 16, 256, generator=g) for _ in range(4))
    dense = tm.build_pyramids(fmaps)
    calls = _force_route(monkeypatch, tm, "default")
    monkeypatch.setattr(prior_raft, "LEAN_BUILD_QUERIES", 128)
    assert tm.build_pyramids(fmaps) and calls == []
    monkeypatch.setattr(prior_raft, "LEAN_BUILD_QUERIES", 127)
    lean = tm.build_pyramids(fmaps)
    assert len(calls) == 2
    for d, l in zip(dense, lean):
        assert all(torch.equal(a, b) for a, b in zip(d, l))


def test_forward_matches_jax_batch_2(models):
    """Batch 2: the encoders batch 4B views and the lookup runs B*Q
    queries."""
    jm, variables, tm = models
    _compare(jm, variables, tm, 64, 128, 2, seed=4, B=2)


@pytest.mark.slow  # 128x256 with 12 iterations: about a minute on the CPU
def test_forward_matches_jax_128x256_12_iters(models):
    jm, variables, tm = models
    _compare(jm, variables, tm, 128, 256, 12, seed=3)


def test_mixed_precision_forward_is_finite(models):
    _, variables, _ = models
    tm = build_model("cpu", state_dict=state_dict_from_jax(variables),
                     mixed_precision=True)
    i1, i2 = _pair(2, 64, 128)
    flow = tm(torch.from_numpy(i1), torch.from_numpy(i2), iters=2)
    assert flow.shape == (1, 64, 128, 2) and flow.dtype == torch.float32
    assert torch.isfinite(flow).all()


def test_strict_load_key_set_matches_export(models, tmp_path):
    """The port registers exactly the reference key set, including each
    strided block's downsample.1 alias; a .pth with a ``module.`` prefix
    and a ``state_dict`` wrapper loads too."""
    _, variables, _ = models
    ref = export_state_dict(variables, add_module_prefix=False)
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(ref)
    assert set(PriOrRAFT().state_dict()) == set(ref)
    assert "cnet.layer2.0.downsample.1.running_var" in sd
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    loaded = load_pth(str(path))
    assert set(loaded) == set(ref)
    PriOrRAFT().load_state_dict(loaded, strict=True)
    assert strip_module_prefix({"module.a": 1, "b": 2}) == {"a": 1, "b": 2}


def test_upsample_flow_convex_matches_jax(rng):
    flow = rng.normal(size=(2, 4, 6, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 4, 6, 576)).astype(np.float32)
    ref = np.asarray(jax_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = upsample_flow_convex(torch.from_numpy(flow),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_seeded_init_is_deterministic():
    a = build_model("cpu", seed=3).state_dict()
    b = build_model("cpu", seed=3).state_dict()
    c = build_model("cpu", seed=4).state_dict()
    k = "fnet.conv1.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])


def test_demo_cli_on_cpu(capsys):
    from prior_flow_tpu_torch.cli import demo
    flow = demo.main(["--height", "64", "--width", "128", "--iters", "1",
                      "--device", "cpu"])
    assert tuple(flow.shape) == (1, 64, 128, 2)
    assert "steady-state forward" in capsys.readouterr().out


def test_import_hygiene_and_no_silent_cpu():
    """A fresh interpreter imports the whole port, its tools, serving path
    and op registrations included, without pulling in JAX, the JAX package
    or the repo-root ``tools`` package (which imports JAX), and
    build_model(), serving.export_forward() and serving.aot_compile() with
    no device raise on a host without CUDA instead of running on the
    CPU."""
    code = """
import json, sys
import prior_flow_tpu_torch
import prior_flow_tpu_torch.cli.demo, prior_flow_tpu_torch.checkpoint
import prior_flow_tpu_torch.ops.corr, prior_flow_tpu_torch.ops.kernels
import prior_flow_tpu_torch.train, prior_flow_tpu_torch.eval
import prior_flow_tpu_torch.ops.kernels.dccl_coords
import prior_flow_tpu_torch.ops.kernels.dccl_scatter
import prior_flow_tpu_torch.tools.microbench_vpu_anchor
import prior_flow_tpu_torch.tools.microbench_kernel_split
import prior_flow_tpu_torch.tools.microbench_gridwin
import prior_flow_tpu_torch.eval.evaluate, prior_flow_tpu_torch.utils.flow_viz
import prior_flow_tpu_torch.data.datasets, prior_flow_tpu_torch.data.native
import prior_flow_tpu_torch.cli.evaluate, prior_flow_tpu_torch.cli.video
import prior_flow_tpu_torch.cli.demo_image, prior_flow_tpu_torch.cli.train
import prior_flow_tpu_torch.data.augmentor, prior_flow_tpu_torch.data.loader
import prior_flow_tpu_torch.data.factory, prior_flow_tpu_torch.utils.logger
import prior_flow_tpu_torch.utils.profiling
import prior_flow_tpu_torch.serving, prior_flow_tpu_torch.cli.export
import prior_flow_tpu_torch.ops.kernels.library
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "prior_flow_tpu", "tools"))
raised = None
import torch
from prior_flow_tpu_torch import serving
if not torch.cuda.is_available():
    model = prior_flow_tpu_torch.build_model("cpu")
    calls = [prior_flow_tpu_torch.build_model,
             lambda: serving.export_forward(model, model.state_dict(),
                                            (1, 32, 64), 1),
             lambda: serving.aot_compile(model, model.state_dict(),
                                         (1, 32, 64), 1)]
    raised = []
    for call in calls:
        try:
            call()
        except RuntimeError:
            raised.append(True)
        else:
            raised.append(False)
ops = sorted(n for n in ("dccl_lookup_levels", "dccl_level_lookup_coords",
                         "dccl_cross_coords", "instance_norm_sums")
             if hasattr(torch.ops.priorflow, n))
print(json.dumps({"bad": bad, "raised": raised, "ops": ops}))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert len(res["ops"]) == 4
    if not torch.cuda.is_available():
        assert res["raised"] == [True, True, True]


def test_no_jax_imports_in_port_sources():
    """No module of the port, and not chip_smoke.py, imports JAX, Flax, the
    JAX package or the repo-root ``tools`` package (the JAX package's
    measurement tools, which import JAX), not even inside a function. The
    port's own tools are ``prior_flow_tpu_torch.tools``."""
    pat = re.compile(
        r"^\s*(from|import)\s+(jax|flax|prior_flow_tpu|tools)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "prior_flow_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
