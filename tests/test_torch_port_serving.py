"""The port's serving path (``prior_flow_tpu_torch.serving``,
``cli/export.py``, the ``priorflow::`` ops) and the Orbax bridge
(``convert_orbax.py``) on the CPU, at ``tests/test_serving.py``'s size
(32x64, 2 iterations).

Tolerances:
- the AOTInductor package against the live model: ``atol=1e-5``, JAX's
  ``tests/test_serving.py`` gate (Inductor fuses and reorders the plain
  code's arithmetic; the kernels' plain versions run as they are);
- a ``torch.export`` program against the eager forward: bitwise (the same
  ATen ops in the same order), also through a file, in mixed precision and
  on each lookup route;
- the port against JAX's ``serving.make_forward`` on the same weights:
  ``FLOW_TOL`` = 1e-3 of the flow scale, as
  ``tests/test_torch_port_model.py``;
- the ops: ``torch.library.opcheck`` (schema, fake implementation,
  dynamic shapes), which compares exactly.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_orbax
from prior_flow_tpu import serving as jax_serving
from prior_flow_tpu.checkpoint.orbax_io import (save_train_state,
                                                save_variables)
from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
from prior_flow_tpu_torch import serving
from prior_flow_tpu_torch.checkpoint import state_dict_from_jax, write_pth
from prior_flow_tpu_torch.cli import demo_image
from prior_flow_tpu_torch.cli import export as export_cli
from prior_flow_tpu_torch.geometry import rotation_grids
from prior_flow_tpu_torch.models import build_model
from prior_flow_tpu_torch.ops.corr import DCCLFused, dccl_level_lookup_plain
from prior_flow_tpu_torch.ops.kernels import library
from test_torch_port_nn import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, ITERS = 32, 64, 2
FLOW_TOL = 1e-3   # max abs error / flow scale, port against JAX
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
def jax_flow(models):
    """JAX's ``serving.make_forward`` on ``_pair()``."""
    jm, variables, _, _ = models
    i1, i2 = _pair()
    fn = jax.jit(jax_serving.make_forward(jm, ITERS))
    return np.asarray(fn(variables, jnp.asarray(i1.numpy()),
                         jnp.asarray(i2.numpy())))


@pytest.fixture(scope="module")
def compiled(models, tmp_path_factory):
    """One AOTInductor compile for the module (~35-60 s on a CPU host)."""
    _, _, tm, state = models
    path = str(tmp_path_factory.mktemp("aoti") / "prior_raft.pt2")
    return serving.aot_compile(tm, state, (1, H, W), ITERS,
                               package_path=path, device="cpu")


def _assert_near_jax(flow, ref):
    err = float(np.abs(flow - ref).max())
    scale = float(np.abs(ref).max())
    print(f"max abs err {err:.3e}, flow scale {scale:.3f}")
    assert flow.shape == ref.shape == (1, H, W, 2)
    assert err <= FLOW_TOL * scale


def _op_counts(exported) -> dict:
    """Calls of each priorflow:: op in an exported program, its nested
    graphs included."""
    counts = {}
    for gm in exported.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for n in gm.graph.nodes:
                name = getattr(n.target, "name", lambda: "")()
                if name.startswith("priorflow::"):
                    key = name.split("::")[1].split(".")[0]
                    counts[key] = counts.get(key, 0) + 1
    return counts


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


# -- the exported program -----------------------------------------------------

def test_forward_and_export_leave_the_model_as_it_was(models):
    """Neither a call of ``make_forward`` with another state nor an export
    leaves a swapped-in tensor in the model (the reference layout registers
    each strided block's norm3 twice, as downsample.1 too)."""
    _, variables, _, _ = models
    tm = build_model("cpu", state_dict=state_dict_from_jax(variables),
                     precision="highest")
    before = {k: (type(v), v.data_ptr()) for k, v in tm.state_dict().items()}
    other = build_model("cpu", seed=1).state_dict()
    serving.make_forward(tm, 1)(other, *_pair())
    serving.export_forward(tm, other, (1, H, W), 1, device="cpu")
    assert {k: (type(v), v.data_ptr())
            for k, v in tm.state_dict().items()} == before
    with pytest.raises(ValueError, match="lacks"):
        serving.make_forward(tm, 1)(
            {k: v for k, v in other.items() if "norm3" not in k}, *_pair())


def test_export_roundtrip_through_file(models, tmp_path):
    _, _, tm, state = models
    i1, i2 = _pair()
    exported = serving.export_forward(tm, state, (1, H, W), ITERS,
                                      device="cpu")
    path = str(tmp_path / "prior_raft.pt2")
    serving.save_exported(exported, path)
    fn = serving.load_exported(path)
    want = serving.make_forward(tm, ITERS)(state, i1, i2)
    assert torch.equal(exported.module()(dict(state), i1, i2), want)
    assert torch.equal(fn(state, i1, i2), want)
    assert fn.exported.graph_module.meta[serving.export.META_KEY][
        "state_keys"] == list(state)


def test_exported_summary(models):
    _, _, tm, state = models
    exported = serving.export_forward(tm, state, (1, H, W), ITERS,
                                      device="cpu")
    assert serving.exported_summary(exported) == {
        "platforms": ["cpu"],
        "in_avals": [f"float32[1,{H},{W},3]"] * 2,
        "out_avals": [f"float32[1,{H},{W},2]"],
        "num_weight_leaves": len(state),
        "precision": "highest"}
    with pytest.raises(ValueError, match="item 11"):
        serving.export_forward(tm, state, (1, H, W), ITERS,
                               platforms=["cuda", "cpu"], device="cpu")


def test_load_exported_without_model_code(models, tmp_path):
    """A process that imports ``prior_flow_tpu_torch.serving`` (and so the
    op registrations) but never the model code loads and runs the
    program, bitwise the live model."""
    _, _, tm, state = models
    i1, i2 = _pair()
    path = str(tmp_path / "prior_raft.pt2")
    serving.save_exported(serving.export_forward(tm, state, (1, H, W),
                                                 ITERS, device="cpu"), path)
    torch.save({"state": dict(state), "images": (i1, i2)},
               str(tmp_path / "inputs.pt"))
    code = f"""
import json, sys, torch
from prior_flow_tpu_torch import serving
fn = serving.load_exported({path!r})
inputs = torch.load({str(tmp_path / 'inputs.pt')!r}, weights_only=True)
torch.save(fn(inputs["state"], *inputs["images"]),
           {str(tmp_path / 'flow.pt')!r})
print(json.dumps(sorted(m for m in sys.modules if m.startswith(
    ("prior_flow_tpu_torch.models", "prior_flow_tpu.", "jax")))))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    flow = torch.load(str(tmp_path / "flow.pt"), weights_only=True)
    assert torch.equal(flow, serving.make_forward(tm, ITERS)(state, i1, i2))


def test_exported_program_matches_jax(models, jax_flow):
    """The port's exported program, on the weights of JAX's variables,
    against JAX's ``serving.make_forward``."""
    _, _, tm, state = models
    exported = serving.export_forward(tm, state, (1, H, W), ITERS,
                                      device="cpu")
    flow = exported.module()(dict(state), *_pair())
    _assert_near_jax(flow.numpy(), jax_flow)


@pytest.mark.parametrize("route", ["default", "mixed_precision", "planes",
                                   "fused_levels", "gather"])
def test_export_is_bitwise_eager(models, route):
    """Export changes nothing on the CPU, on every lookup route and in
    mixed precision; the program calls the route's ops, once per forward
    for the coords, once per iteration for the lookups, and the sums once
    per fnet norm."""
    _, variables, _, _ = models
    tm = build_model("cpu", state_dict=state_dict_from_jax(variables),
                     precision="highest",
                     mixed_precision=route == "mixed_precision")
    if route == "planes":
        tm.dccl = DCCLFused(4, grid_in_kernel=False)
    elif route == "fused_levels":
        tm.dccl = DCCLFused(4, fuse_levels=True)
    elif route == "gather":
        tm.dccl = DCCLFused(4, level_lookup=dccl_level_lookup_plain)
    state = tm.state_dict()
    exported = serving.export_forward(tm, state, (1, H, W), ITERS,
                                      device="cpu")
    i1, i2 = _pair()
    assert torch.equal(exported.module()(dict(state), i1, i2),
                       tm(i1, i2, iters=ITERS))
    want = {"instance_norm_sums": 15}
    if route == "planes":
        want.update(dccl_cross_coords=ITERS,
                    dccl_level_lookup_coords=4 * ITERS)
    elif route != "gather":
        want["dccl_lookup_levels"] = ITERS
    assert _op_counts(exported) == want


# -- the ops ------------------------------------------------------------------

def _lookup_args(dtype, h=8, w=16, levels=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    Q = h * w
    vols = [torch.randn(1, Q, h >> lvl, w >> lvl, generator=g).to(dtype)
            for lvl in range(levels) for _ in range(2)]
    u = torch.rand(2, 1, Q, generator=g)
    cen_A = torch.stack([u[0] * w, u[1] * h], dim=-1)
    cen_B = torch.roll(cen_A, 1, dims=1) + 0.37
    grids = rotation_grids(8 * h, 8 * w)
    grid_A, grid_B = (torch.from_numpy(grids.a2b_w2c_8),
                      torch.from_numpy(grids.b2a_w2c_8))
    scales = [1.0 / 2 ** i for i in range(levels)]
    return vols[0::2], vols[1::2], cen_A, cen_B, grid_A, grid_B, scales


OP_CASES = ["lookup_levels_float32", "lookup_levels_bfloat16",
            "lookup_coords_float32", "lookup_coords_bfloat16",
            "cross_coords", "sums_float32", "sums_bfloat16"]


def _op_case(case):
    """(op, args) of one ``OP_CASES`` entry, on CPU tensors; the bf16
    lookup takes the all-levels launch (``fuse``)."""
    kind, _, tag = case.rpartition("_")
    dtype = getattr(torch, tag, torch.float32)
    vA, vB, cA, cB, gA, gB, scales = _lookup_args(dtype)
    if case == "cross_coords":
        return library.dccl_cross_coords, (cA, cB, gA, gB, scales)
    if kind == "lookup_levels":
        return library.dccl_lookup_levels, (vA, vB, cA, cB, gA, gB, scales,
                                            dtype == torch.bfloat16)
    if kind == "lookup_coords":
        xy = [c.reshape(1, -1, 81)
              for c in library.dccl_cross_coords(cA, cB, gA, gB, [1.0])]
        return library.dccl_level_lookup_coords, (vA[0], vB[0], cA, cB, 1.0,
                                                  *xy)
    x = torch.randn(2, 3, 5, 7,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    return library.instance_norm_sums, (x, x)


@pytest.mark.parametrize("case", OP_CASES)
def test_opcheck(case):
    op, args = _op_case(case)
    torch.library.opcheck(op, args)


def test_ops_are_the_plain_versions_on_the_cpu():
    """The CPU implementation of each op is its kernel's plain version,
    bitwise; the lookup's fields hold the levels side by side."""
    from prior_flow_tpu_torch.ops.kernels import dccl_lookup

    vA, vB, cA, cB, gA, gB, scales = _lookup_args(torch.float32)
    fields = library.dccl_lookup_levels(vA, vB, cA, cB, gA, gB, scales,
                                        False)
    for lvl, s in enumerate(scales):
        plain = dccl_lookup.dccl_level_lookup_plain(vA[lvl], vB[lvl], cA, cB,
                                                    gA, gB, s)
        for f, p in zip(fields, plain):
            assert torch.equal(f[..., 81 * lvl:81 * (lvl + 1)], p)


# -- the CLI and the Orbax bridge ---------------------------------------------

@pytest.mark.parametrize("lookup_mode", ["auto", "gather"])
def test_export_cli_writes_and_checks(models, tmp_path, capsys, lookup_mode):
    _, _, tm, state = models
    pth = write_pth(state, str(tmp_path / "w.pth"))
    out = str(tmp_path / "m.pt2")
    export_cli.main(["--model", pth, "--output", out, "--size", str(H),
                     str(W), "--iters", str(ITERS), "--check",
                     "--lookup_mode", lookup_mode, "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0]["output"] == out and lines[0]["platforms"] == ["cpu"]
    assert lines[0]["in_avals"] == [f"float32[1,{H},{W},3]"] * 2
    assert lines[1]["check_max_abs_err"] < 1e-3
    assert os.path.getsize(out) > 0


def test_export_cli_refusals(models, tmp_path):
    _, _, tm, state = models
    pth = write_pth(state, str(tmp_path / "w.pth"))
    base = ["--output", str(tmp_path / "m.pt2"), "--size", str(H), str(W),
            "--iters", "1", "--device", "cpu"]
    with pytest.raises(ValueError, match="convert_orbax.py"):
        export_cli.main(["--model", str(tmp_path), *base])
    with pytest.raises(SystemExit):
        export_cli.main(["--model", pth, "--lookup_mode", "mxu", *base])
    with pytest.raises(ValueError, match="item 11"):
        export_cli.main(["--model", pth, "--platforms", "cuda", *base])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            export_cli.main(["--model", pth, *base[:-2]])


@pytest.mark.parametrize("layout", ["train_state", "variables"])
def test_convert_orbax_bridge(models, jax_flow, tmp_path, layout):
    """JAX's Orbax checkpoint (a Trainer TrainState or bare variables)
    through ``convert_orbax.py`` loads strictly into the port, whose
    forward then matches JAX's."""
    _, variables, _, _ = models
    ckpt = str(tmp_path / "ckpt")
    if layout == "train_state":
        save_train_state(ckpt, {"params": variables["params"],
                                "batch_stats": variables["batch_stats"],
                                "step": np.int32(3)})
    else:
        save_variables(ckpt, variables)
    out = str(tmp_path / "w.pth")
    convert_orbax.main([ckpt, out])
    tm = build_model("cpu", state_dict=demo_image.load_model_state(out),
                     precision="highest")
    _assert_near_jax(tm(*_pair(), iters=ITERS).numpy(), jax_flow)


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


def test_a_package_without_serving_metadata_is_refused(tmp_path):
    """``CompiledForward`` loads only packages of ``aot_compile``: one
    without their metadata (signature, state names, precision) raises."""
    class Add(torch.nn.Module):
        def forward(self, x):
            return x + 1

    exported = torch.export.export(Add(), (torch.zeros(2),))
    path = torch._inductor.aoti_compile_and_package(
        exported, package_path=str(tmp_path / "add.pt2"))
    with pytest.raises(ValueError, match="aot_compile"):
        serving.export.CompiledForward(path)


def test_ops_require_their_traced_strides():
    """Every priorflow:: op is tagged ``needs_exact_strides``: a compiler
    hands it its inputs with the strides they had when traced (the
    model's, contiguous), as the kernels' wrappers require."""
    for op in library.OPS:
        tags = op._opoverload.tags
        assert torch.Tag.needs_exact_strides in tags, op


# cuDNN kernel names read on an H100 (tools/serving_precision.py)
FP32_CONV = ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
             "tilesize256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_"
             "execute_kernel__5x_cudnn")
TF32_CONV = ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_"
             "tilesize128x64x32_warpgroupsize1x1x1_g1_execute_segment_k_off_"
             "kernel__5x_cudnn")
BF16_CONV = ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
             "nhwc_tilesize64x64x64_warpgroupsize1x1x1_g1_execute_segment_k_"
             "off_kernel__5x_cudnn")
BF16_DIRECT = ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, "
               "1024, 5, 5, 3, 3, 3, 1, false, false, true>(int, int, int)")
FP32_DIRECT = ("void convolve_common_engine_float_NHWC<float, float, 1024, 5, "
               "5, 3, 3, 3, true, false, false, false, false>(int, int, int)")


@pytest.mark.parametrize("names, fp32, bf16", [
    ([FP32_CONV, FP32_DIRECT], True, False),
    ([FP32_CONV, TF32_CONV], False, False),
    ([BF16_CONV, BF16_DIRECT], True, True),
    ([BF16_CONV, FP32_DIRECT], True, False),
    ([], False, False)])
def test_precision_by_kernel_name(names, fp32, bf16):
    """Phase 20's precision rule on convolution kernels' names: fp32 when
    none is TF32, bf16 when every one is bf16; no convolution passes
    neither. Inductor's Triton kernels and non-convolution kernels are not
    convolutions."""
    from prior_flow_tpu_torch.tools import serving_precision as sp
    events = [(1.0, 2, name) for name in names] + [
        (1.0, 3, "triton_poi_fused_convolution_relu_7"),
        (1.0, 1, "sm80_xmma_gemm_f32f32_tf32f32_f32_tn_n_cublas")]
    convs = sp.conv_kernels(events)
    assert convs == dict.fromkeys(names, 2)
    assert sp.precision_by_name(convs, "fp32") == fp32
    assert sp.precision_by_name(convs, "bf16") == bf16
