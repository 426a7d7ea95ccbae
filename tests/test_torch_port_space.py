"""Height sharding of the port (the ``space`` axis: ``parallel/spatial.py``,
``make_mesh_2d``, ``spatial_batch_sharding``, ``make_train_step(mesh=)``,
``Trainer(mesh=)``, ``dryrun_multichip``) on the CPU over gloo.

The oracle is the port's own one-process result, which
``tests/test_torch_port_model.py`` and ``..._train.py`` hold to JAX's, as
JAX's ``tests/test_train_parallel.py:150-213`` holds its data x space
step to the single-device one. Two pools of spawned ranks, a 1x2 and a
2x2 mesh, each run every case once (``_rank_cases``); this process
computes the references meanwhile. Tolerances:
- the sharded convolution (every geometry of the encoders and update
  blocks, at S = 2 and 4, halos up to 3 rows over ranks of 2) and the
  instance norm: forward and both gradients within 1e-6 of the largest
  magnitude of the unsplit layer's;
- the 64x128, 2-iteration test-mode forward: within 1e-5 x flow scale;
- the standard step at batch 2: gradients within 1e-5 of the global norm
  (relative L2 over all tensors), ``train/loss`` and ``train/grad_norm``
  within rtol 1e-5, the updated parameters within JAX's atol 1e-5, the
  pixel-count metrics equal; every rank's gradients and parameters
  bitwise rank 0's;
- the group norm and the batch-statistics BatchNorm (its statistics over
  the data axis too on the 2x2 mesh): as the instance norm, 1e-6, the
  running statistics bitwise the same on every rank;
- the dropout and noise draws: bitwise the one-process draws' rows.

Inputs are seeded numpy arrays. The ranks run ``_rank_cases`` of this
module, which imports nothing of JAX.
"""

import concurrent.futures
import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from prior_flow_tpu_torch.models import build_model
from prior_flow_tpu_torch.cli import train as tcli
from prior_flow_tpu_torch.nn.layers import (BatchNorm, Conv2d, GroupNorm,
                                            InstanceNorm, RankDraws, dropout)
from prior_flow_tpu_torch.parallel import dryrun, mesh as pmesh, spatial
from prior_flow_tpu_torch.train.trainer import draw_noise

HW = dryrun.DRYRUN_HW
ITERS = 2
LAYER_TOL = 1e-6          # of the unsplit layer's largest magnitude
FLOW_TOL = 1e-5           # x flow scale
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
MESHES = ((1, 2), (2, 2))
# (kernel, stride, padding) of every convolution of the encoders and the
# update blocks
GEOMETRIES = [((7, 7), 2, (3, 3)), ((3, 3), 1, (1, 1)), ((3, 3), 2, (1, 1)),
              ((1, 1), 2, (0, 0)), ((1, 1), 1, (0, 0)), ((7, 7), 1, (3, 3)),
              ((1, 5), 1, (0, 2)), ((5, 1), 1, (2, 0))]
# B, C, H, W: 4 rows per rank at S = 2, 2 at S = 4 (where the 7x7 convs'
# 3-row halo reaches over a whole rank)
LAYER_SHAPE = (2, 3, 8, 12)
FORWARDS = {"volume": {}, "onthefly": dict(corr_mode="onthefly")}
STEPS = {"plain": ({}, dict(remat=False)),
         "remat_dccl": ({}, dict(remat=True, remat_policy="dccl")),
         "noise_dropout": (dict(noise=True, dropout=0.1), dict(remat=False)),
         "onthefly": ({}, dict(remat=False, corr_mode="onthefly"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``test_torch_port_parallel.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _conv_case(i: int):
    """Geometry i's seeded convolution, input and output cotangent."""
    kernel, stride, padding = GEOMETRIES[i]
    rng = np.random.default_rng(100 + i)
    conv = Conv2d(LAYER_SHAPE[1], 5, kernel, stride=stride, padding=padding)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(_np(rng, p.shape))
    x = _np(rng, LAYER_SHAPE)
    with torch.no_grad():
        out_shape = torch.nn.Conv2d.forward(conv, x).shape
    return conv, x, _np(rng, out_shape)


def _norm_case():
    rng = np.random.default_rng(7)
    x = _np(rng, LAYER_SHAPE) * 3.0 + 1.5
    return x, _np(rng, LAYER_SHAPE)


def _affine_norms():
    """The norms with parameters, their affine seeded: the group norm (3
    groups of LAYER_SHAPE's channels) and the batch-statistics
    BatchNorm."""
    rng = np.random.default_rng(8)
    norms = {"group": GroupNorm(3, 6), "batch": BatchNorm(6)}
    for norm in norms.values():
        with torch.no_grad():
            for p in norm.parameters():
                p.copy_(_np(rng, p.shape) * 0.5 + 1.0)
    return norms


def _wide_norm_case():
    """The instance norm's case at 6 channels (the group norm's groups)."""
    x, ct = _norm_case()
    return torch.cat([x, 0.5 * x - 2.0], 1), torch.cat([ct, -ct], 1)


def _layer_grads(layer, x, ct, space=None, batch=False):
    """(output, input gradient, parameter gradients, buffers) of ``layer``
    at ``x`` (this rank's rows under ``space``, the parameter gradients
    summed over it, with ``batch`` over every rank of the global
    batch)."""
    x = x.clone().requires_grad_()
    with spatial.scope(space):
        y = layer(x)
    y.backward(ct)
    grads = [p.grad for p in layer.parameters()]
    if space is not None:
        grads = [space.all_reduce_(g, batch) for g in grads]
    return y.detach(), x.grad, grads, [b.clone() for b in layer.buffers()]


def _batch_rows(t, mesh, space):
    """This rank's rows of a global (B, C, H, W) layer input under
    ``space``: its data rank's batch rows where the space has a data
    axis, and its height rows."""
    if space.data > 1:
        b = t.shape[0] // space.data
        t = t[mesh.data_rank * b:(mesh.data_rank + 1) * b]
    return spatial.rows(t, space, 2)


def _rank_cases(mesh, batch):
    """Every case on this rank: the layers (at its space group's S and, on
    a 2x2 mesh, at S = 4 over all ranks), the forwards, the steps, and its
    subgroups."""
    spaces = {mesh.space_size: mesh.space}
    if mesh.size == 4:
        spaces[4] = spatial.Space(None, mesh.rank, 4, mesh.backend)
    out = {"layers": {}, "norm": {}, "group": {}, "batch": {}}
    for S, space in spaces.items():
        for i in range(len(GEOMETRIES)):
            conv, x, ct = _conv_case(i)
            out["layers"][S, i] = _layer_grads(
                conv, spatial.rows(x, space, 2), spatial.rows(ct, space, 2),
                space)
        x, ct = _norm_case()
        out["norm"][S] = _layer_grads(InstanceNorm(), spatial.rows(
            x, space, 2), spatial.rows(ct, space, 2), space)
        x, ct = _wide_norm_case()
        norms = _affine_norms()
        out["group"][S] = _layer_grads(norms["group"], spatial.rows(
            x, space, 2), spatial.rows(ct, space, 2), space)
        out["batch"][S] = _layer_grads(
            norms["batch"], _batch_rows(x, mesh, space),
            _batch_rows(ct, mesh, space), space, batch=True)
    out["forward"] = {
        mode: dryrun.forward_rows(mesh, [(*batch[:2], ITERS)], 0, 1, kw)[0]
        for mode, kw in FORWARDS.items()}
    out["steps"] = {
        name: dryrun.rank_updates(mesh, [dict(case, iters=ITERS)], batch, 1,
                                  0, kw)[0]
        for name, (case, kw) in STEPS.items()}
    out["groups"] = dict(
        space=dist.get_process_group_ranks(mesh.space.group),
        data=(None if mesh.data_group is None
              else dist.get_process_group_ranks(mesh.data_group)),
        coords=(mesh.data_rank, mesh.space_rank), shape=dict(mesh.shape),
        route=mesh.space.route)
    return out


def _dryrun_4():
    """``dryrun_multichip(4)`` on the CPU and the line it printed."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = dryrun.dryrun_multichip(4, device="cpu")
    return res, out.getvalue()


@pytest.fixture(scope="module")
def runs():
    """Both pools' results and ``dryrun_multichip(4)``'s, beside this
    process's references (nothing else here prints while the dryrun's
    line is captured)."""
    batch = dryrun.synthetic_batch(3, 2, *HW)
    with concurrent.futures.ThreadPoolExecutor(len(MESHES) + 1) as pool:
        spawned = {shape: pool.submit(dryrun.spawn, _rank_cases,
                                      shape[0] * shape[1], batch,
                                      device="cpu", shape=shape)
                   for shape in MESHES}
        spawned["dryrun"] = pool.submit(_dryrun_4)
        refs = {"forward": {
            mode: build_model("cpu", seed=0, **kw)(*batch[:2], iters=ITERS)
            for mode, kw in FORWARDS.items()}}
        refs["steps"] = {
            name: dryrun.train_once(None, "cpu", dict(case, iters=ITERS),
                                    batch, **kw)
            for name, (case, kw) in STEPS.items()}
        ranks = {shape: f.result() for shape, f in spawned.items()}
    return refs, ranks


def _whole(ranks, shape, rows_of):
    """A global (B, H, ...) tensor from each rank's rows (``rows_of``)."""
    D, S = shape
    per_data = [torch.cat([rows_of(ranks[d * S + s]) for s in range(S)],
                          dim=1) for d in range(D)]
    return torch.cat(per_data, dim=0)


def _close(got, want, tol):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, tol)
    return err


def _layer_ranks(runs, S: int):
    """(rank, result) of every rank that ran the layers at S."""
    pools = MESHES if S == 2 else [(2, 2)]
    return [(r, res) for shape in pools
            for r, res in enumerate(runs[1][shape])]


@pytest.mark.parametrize("S", (2, 4))
@pytest.mark.parametrize("i", range(len(GEOMETRIES)))
def test_sharded_conv_is_the_unsplit_conv(runs, S, i):
    """Every rank's output rows, input-gradient rows and summed weight and
    bias gradients within 1e-6 of the unsplit convolution's (S = 2 on both
    meshes, S = 4 over the 2x2 mesh's four ranks)."""
    conv, x, ct = _conv_case(i)
    y, dx, (dw, db), _ = _layer_grads(conv, x, ct)
    for r, res in _layer_ranks(runs, S):
        space = spatial.Space(None, r % S, S, "gloo")
        got_y, got_dx, (got_dw, got_db), _ = res["layers"][S, i]
        _close(got_y, spatial.rows(y, space, 2), LAYER_TOL)
        _close(got_dx, spatial.rows(dx, space, 2), LAYER_TOL)
        _close(got_dw, dw, LAYER_TOL)
        _close(got_db, db, LAYER_TOL)


@pytest.mark.parametrize("S", (2, 4))
def test_sharded_instance_norm_is_the_unsplit_norm(runs, S):
    """The statistics of the whole image: output rows and input-gradient
    rows within 1e-6 of the unsplit norm's."""
    x, ct = _norm_case()
    y, dx, _, _ = _layer_grads(InstanceNorm(), x, ct)
    for r, res in _layer_ranks(runs, S):
        space = spatial.Space(None, r % S, S, "gloo")
        got_y, got_dx, _, _ = res["norm"][S]
        _close(got_y, spatial.rows(y, space, 2), LAYER_TOL)
        _close(got_dx, spatial.rows(dx, space, 2), LAYER_TOL)


@pytest.mark.parametrize("kind", ("group", "batch"))
@pytest.mark.parametrize("S", (2, 4))
def test_sharded_affine_norms_are_the_unsplit_norms(runs, S, kind):
    """The group norm (per-sample statistics over the space group) and the
    batch-statistics BatchNorm (per-channel statistics over every rank of
    the global batch: on the 2x2 mesh at S = 2 the batch rows are split
    over the data axis too): output rows, input-gradient rows and the
    summed parameter gradients within 1e-6 of the unsplit norm's; the
    BatchNorm's running statistics within 1e-6 of the unsplit norm's and
    bitwise the same on every rank."""
    x, ct = _wide_norm_case()
    y, dx, grads, bufs = _layer_grads(_affine_norms()[kind], x, ct)
    pools = MESHES if S == 2 else [(2, 2)]
    for shape in pools:
        ranks = runs[1][shape]
        D = shape[0] if (S == 2 and kind == "batch") else 1
        for r, res in enumerate(ranks):
            got_y, got_dx, got_grads, got_bufs = res[kind][S]
            if D > 1:   # the rank's batch rows and height rows
                d, s = divmod(r, S)
                space = spatial.Space(None, s, S, "gloo")
                rows = lambda t: spatial.rows(t[d:d + 1], space, 2)
            else:
                space = spatial.Space(None, r % S, S, "gloo")
                rows = lambda t: spatial.rows(t, space, 2)
            _close(got_y, rows(y), LAYER_TOL)
            _close(got_dx, rows(dx), LAYER_TOL)
            for g, want in zip(got_grads, grads):
                _close(g, want, LAYER_TOL)
            for b, want, b0 in zip(got_bufs, bufs, ranks[0][kind][S][3]):
                _close(b, want, LAYER_TOL)
                assert torch.equal(b, b0)


@pytest.mark.parametrize("mode", FORWARDS)
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_forward_is_the_one_process_forward(runs, shape, mode):
    """The 64x128, 2-iteration test-mode forward, batch 2: the ranks' rows
    within 1e-5 x flow scale of the one-process flow; the exchange route
    named."""
    refs, ranks = runs[0], runs[1][shape]
    flow = _whole(ranks, shape, lambda r: r["forward"][mode]["flow"])
    err = _close(flow, refs["forward"][mode], FLOW_TOL)
    print(f"{shape} {mode}: {err:.3e} of flow scale "
          f"{refs['forward'][mode].abs().max().item():.3f}; route "
          f"{ranks[0]['forward'][mode]['route']}")


def _global_norm(tensors):
    return math.sqrt(sum(float((t.double() ** 2).sum())
                         for t in tensors.values()))


@pytest.mark.parametrize("name", STEPS)
@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_is_the_batch_2_step(runs, shape, name):
    """The standard step, batch 2, 64x128, 2 iterations: gradients before
    the clip, loss, grad norm, updated parameters and pixel counts against
    the one-process step; every rank's gradients and parameters bitwise
    rank 0's."""
    ref, ranks = runs[0]["steps"][name], runs[1][shape]
    got = ranks[0]["steps"][name]
    assert all(r["steps"][name]["grads_same"]
               and r["steps"][name]["params_same"] for r in ranks)
    g, want = got["grads"], ref["grads"]
    assert g.keys() == want.keys()
    dist_ = _global_norm({k: g[k] - want[k] for k in want})
    norm = _global_norm(want)
    print(f"{shape} {name}: gradients {dist_ / norm:.3e} of the global norm")
    assert dist_ <= GRAD_RTOL * norm
    for k in ("train/loss", "train/grad_norm"):
        assert got["metrics"][k] == pytest.approx(ref["metrics"][k],
                                                  rel=LOSS_RTOL), k
    for k, v in ref["metrics"].items():
        if k.endswith("px"):
            assert got["metrics"][k] == v, k
    for k, p in ref["params"].items():
        torch.testing.assert_close(got["params"][k], p, atol=PARAM_ATOL,
                                   rtol=0)


def test_make_mesh_2d_groups(runs):
    """On the 2x2 mesh rank d * 2 + s has data index d and space index s;
    its space group holds the ranks of its data index, its data group
    those of its space index; on the 1x2 mesh there is no data group."""
    for r, res in enumerate(runs[1][(2, 2)]):
        d, s = divmod(r, 2)
        assert res["groups"]["coords"] == (d, s)
        assert res["groups"]["shape"] == {"data": 2, "space": 2}
        assert res["groups"]["space"] == [2 * d, 2 * d + 1]
        assert res["groups"]["data"] == [s, 2 + s]
        assert res["groups"]["route"].startswith("gloo: ")
    for r, res in enumerate(runs[1][(1, 2)]):
        assert res["groups"]["space"] == [0, 1]
        assert res["groups"]["data"] is None


@pytest.mark.parametrize("D,S", [(1, 2), (2, 2), (1, 4)])
def test_draws_are_the_one_process_draws(D, S):
    """Dropout (NCHW, two views) and noise (channels-last) draws of a
    ``RankDraws`` with data and space ranks: bitwise the one-process
    draws' rows."""
    B, C, H, W = 2 * D, 3, 8 * S, 16
    full_drop = dropout(torch.ones(2 * B, C, H, W), 0.1,
                        torch.Generator().manual_seed(5), views=2)
    full_noise = draw_noise(torch.zeros(B, H, W, 3),
                            torch.Generator().manual_seed(6))
    b, h = B // D, H // S
    for d in range(D):
        for s in range(S):
            draws = lambda seed: RankDraws(torch.Generator().manual_seed(
                seed), d, D, s, S)
            drop = dropout(torch.ones(2 * b, C, h, W), 0.1, draws(5), views=2)
            want = full_drop.view(2, D, b, C, S, h, W)[:, d, :, :, s]
            assert torch.equal(drop, want.reshape(drop.shape))
            noise = draw_noise(torch.zeros(b, h, W, 3), draws(6))
            assert torch.equal(noise[0], full_noise[0])
            for got, full in zip(noise[1:], full_noise[1:]):
                assert torch.equal(got, full[d * b:(d + 1) * b,
                                             s * h:(s + 1) * h])


def _space(size: int = 2):
    """A ``Space`` over no process group: what raises before any exchange
    raises there."""
    return spatial.Space(None, 0, size, "gloo")


@dataclasses.dataclass(frozen=True)
class _Counts(spatial.Space):
    """A ``Space`` over no process group whose exchange hands back
    ``counts``, as if its ranks held that many rows each."""

    counts: tuple = ()

    def gather_stack(self, x):
        return torch.tensor(self.counts, dtype=x.dtype).view(-1, *x.shape)


def _space_mesh(size: int, rank: int = 0):
    return pmesh.Mesh(None, rank, size, torch.device("cpu"), "gloo",
                      ("data", "space"), {"data": 1, "space": size},
                      space=spatial.Space(None, rank, size, "gloo"))


def test_height_must_split_into_whole_eighth_rows():
    """What JAX refuses still raises, with JAX's reason, in
    ``spatial_batch_sharding`` and in the model's sharded forward: H not a
    multiple of 8 (74 rows over S = 2), which the unsharded model needs,
    and H not a multiple of S (80 rows over S = 3), which
    ``jax.device_put`` needs of ``P('data', 'space')``; the forward also
    refuses rows that are not the strips' (36 + 36 of 72). An uneven H / 8
    shards: 72 rows over S = 2 are 40 + 32."""
    for H, S, reason in ((74, 2, r"not a multiple of 8"),
                         (80, 3, r"should be divisible by 3")):
        images = dryrun.synthetic_batch(0, 1, H, HW[1])[:2]
        with pytest.raises(ValueError, match=reason):
            pmesh.spatial_batch_sharding(_space_mesh(S))(images[0])
        counts = ((40, 34) if S == 2 else (32, 32, 16))
        rows = [t[:, :counts[0]] for t in images]
        with spatial.scope(_Counts(None, 0, S, "gloo", counts=counts)), \
                pytest.raises(ValueError, match=reason):
            build_model("cpu")(*rows, iters=1)
    with spatial.scope(_Counts(None, 0, 2, "gloo", counts=(36, 36))), \
            pytest.raises(ValueError, match=r"not its strips' \[40, 32\]"):
        build_model("cpu")(*[torch.zeros(1, 36, HW[1], 3)] * 2, iters=1)
    image = dryrun.synthetic_batch(0, 1, 72, HW[1])[0]
    got = [pmesh.spatial_batch_sharding(_space_mesh(2, r))(image)
           for r in (0, 1)]
    assert [t.shape[1] for t in got] == [40, 32]
    assert torch.equal(torch.cat(got, 1), image)


def test_mesh_shape_flag():
    """``--mesh DPxSP``: a data x space mesh where SP > 1."""
    assert tcli.mesh_shape("auto") is None
    assert tcli.mesh_shape("2x1") is None
    assert tcli.mesh_shape("1x2") == (1, 2)
    assert tcli.mesh_shape("2x2") == (2, 2)


def test_dryrun_multichip_2x2(runs):
    """The port's ``dryrun_multichip(4)``: JAX's 2 x 2 data x space mesh,
    a global batch of 2, ``Trainer.run`` for 2 updates; JAX's ok line."""
    res, out = runs[1]["dryrun"]
    print(out)
    assert ("dryrun_multichip(4): ok, mesh={'data': 2, 'space': 2}, "
            "Trainer.run 2 steps") in out
    assert np.isfinite(res["loss"]) and res["step"] == 2
