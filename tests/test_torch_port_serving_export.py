"""The port's exported programs (``serving.export_forward``,
``save_exported``, ``exported_summary``) against the eager model on the
CPU, at ``tests/test_serving.py``'s size (32x64, 2 iterations): bitwise,
on every lookup route and in mixed precision, also through a file. These
tests sit apart from ``tests/test_torch_port_serving.py`` so that a
parallel run spreads the serving tests' exports over more workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
from prior_flow_tpu_torch import serving
from prior_flow_tpu_torch.checkpoint import state_dict_from_jax
from prior_flow_tpu_torch.models import build_model
from prior_flow_tpu_torch.ops.corr import DCCLFused, dccl_level_lookup_plain
from test_torch_port_nn import random_variables

H, W, ITERS = 32, 64, 2


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
    with pytest.raises(ValueError, match="lookup_mode='mxu'"):
        serving.export_forward(tm, state, (1, H, W), ITERS,
                               platforms=["cuda", "cpu"], device="cpu")


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
