"""The port's AOTInductor package (``serving.aot_compile``,
``serving.export.CompiledForward``) on the CPU, at
``tests/test_serving.py``'s size (32x64, 2 iterations): one package
compile for the module (the ``compiled`` fixture). These tests sit apart
from ``tests/test_torch_port_serving.py`` so that a parallel run puts
this compile and that module's work on different workers.

Tolerance: the package against the live model ``atol=1e-5``, JAX's
``tests/test_serving.py`` gate (Inductor fuses and reorders the plain
code's arithmetic; the kernels' plain versions run as they are).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
from prior_flow_tpu_torch import serving
from prior_flow_tpu_torch.checkpoint import state_dict_from_jax
from prior_flow_tpu_torch.models import build_model
from test_torch_port_nn import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, ITERS = 32, 64, 2
AOT_ATOL = 1e-5   # the AOTInductor package against the live model


def _pair(seed=7, batch=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.uniform(0, 255, (batch, H, W, 3)).astype(np.float32))
        for _ in range(2))


@pytest.fixture(scope="module")
def models():
    """JAX's model and variables, and the port's model on the same weights
    (CPU, ``precision="highest"``) with its state."""
    jm = JaxPriOrRAFT(precision="highest")
    img = jnp.zeros((1, H, W, 3))
    variables = random_variables(jm, img, img, iters=1)
    tm = build_model("cpu", state_dict=state_dict_from_jax(variables),
                     precision="highest")
    return jm, variables, tm, tm.state_dict()


@pytest.fixture(scope="module")
def compiled(models, tmp_path_factory):
    """One AOTInductor compile for the module (~35-60 s on a CPU host)."""
    _, _, tm, state = models
    path = str(tmp_path_factory.mktemp("aoti") / "prior_raft.pt2")
    return serving.aot_compile(tm, state, (1, H, W), ITERS,
                               package_path=path, device="cpu")


# -- the AOTInductor package --------------------------------------------------

def test_aot_compile_matches_live(models, compiled):
    _, _, tm, state = models
    i1, i2 = _pair()
    got = compiled(state, i1, i2)
    want = serving.make_forward(tm, ITERS)(state, i1, i2)
    err = (got - want).abs().max().item()
    print(f"AOTInductor against eager: max abs err {err:.3e}")
    assert got.shape == (1, H, W, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=AOT_ATOL)


@pytest.mark.parametrize("drift", ["batch", "size", "dtype", "device",
                                   "strides", "state_names", "weight_shape"])
def test_aot_compile_rejects_drift(models, compiled, drift):
    """The package runs only at its compiled signature: any other image
    shape, dtype, device or layout, or state, raises."""
    _, _, _, state = models
    state = dict(state)
    i1, i2 = _pair()
    if drift == "batch":
        i1, i2 = _pair(batch=2)
    elif drift == "size":
        i1 = torch.zeros((1, H, W + 8, 3))
    elif drift == "dtype":
        i1 = i1.double()
    elif drift == "device":
        i1 = i1.to("meta")
    elif drift == "strides":
        i1 = i1.transpose(1, 2).contiguous().transpose(1, 2)
    elif drift == "state_names":
        state.pop(next(iter(state)))
    else:
        k = next(iter(state))
        state[k] = state[k][:1]
    with pytest.raises(ValueError):
        compiled(state, i1, i2)


def test_aot_compile_runs_the_given_state(models, compiled):
    """The weights are the call's state, never ones held from the
    compile: a second seed's state gives that model's flow."""
    _, _, tm, state = models
    other = build_model("cpu", seed=1, precision="highest")
    state2 = other.state_dict()
    i1, i2 = _pair()
    got = compiled(state2, i1, i2)
    want = other(i1, i2, iters=ITERS)
    torch.testing.assert_close(got, want, rtol=0, atol=AOT_ATOL)
    assert (got - compiled(state, i1, i2)).abs().max() > 1e-2


def test_package_loads_alone_without_model_code(models, compiled, tmp_path):
    """A process that imports ``prior_flow_tpu_torch.serving`` but never the
    model code loads the package from its file alone (the signature,
    state names and precision are in its metadata) and gives the live
    model's flow."""
    _, _, tm, state = models
    i1, i2 = _pair()
    torch.save({"state": dict(state), "images": (i1, i2)},
               str(tmp_path / "inputs.pt"))
    code = f"""
import json, sys, torch
from prior_flow_tpu_torch.serving.export import CompiledForward
fn = CompiledForward({compiled.package_path!r})
inputs = torch.load({str(tmp_path / 'inputs.pt')!r}, weights_only=True)
torch.save(fn(inputs["state"], *inputs["images"]),
           {str(tmp_path / 'flow.pt')!r})
print(json.dumps([fn.precision, sorted(m for m in sys.modules
    if m.startswith(("prior_flow_tpu_torch.models", "prior_flow_tpu.",
                     "jax")))]))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == ["highest", []]
    flow = torch.load(str(tmp_path / "flow.pt"), weights_only=True)
    want = serving.make_forward(tm, ITERS)(state, i1, i2)
    torch.testing.assert_close(flow, want, rtol=0, atol=AOT_ATOL)


def test_package_runs_under_its_precision(models, compiled, monkeypatch):
    """The package's call runs under its recorded precision ("highest":
    TF32 off for matmuls and cuDNN convolutions) whatever the caller's
    flags, and puts the caller's flags back."""
    _, _, _, state = models
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn.conv)
    seen = []

    def runner(*args):
        seen.append([f.fp32_precision for f in flags])
        return torch.zeros(())

    monkeypatch.setattr(compiled, "runner", runner)
    saved = [f.fp32_precision for f in flags]
    try:
        for f in flags:
            f.fp32_precision = "tf32"
        compiled(state, *_pair())
        assert [f.fp32_precision for f in flags] == ["tf32", "tf32"]
    finally:
        for f, v in zip(flags, saved):
            f.fp32_precision = v
    assert seen == [["ieee", "ieee"]]
