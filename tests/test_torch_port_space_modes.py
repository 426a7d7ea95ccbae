"""The options of the port that run height-sharded since the space axis
took them (``parallel/spatial.py``): the taped and the deferred training
steps, batch-statistics BatchNorm, the ``mxu`` / ``gather`` lookups and the
legacy RAFT, on the CPU over gloo.

The oracle is the port's own one-process result, which
``tests/test_torch_port_train.py``, ``..._raft.py`` and ``..._lookup.py``
hold to JAX's. One pool of two spawned ranks on a 1x2 data x space mesh
runs every case once (``_rank_cases``) while this process computes the
references and JAX's jitted standard step; the training CLI's two ranks
run beside them. Tolerances are ``tests/test_torch_port_space.py``'s:
- steps (batch 2, 64x128, 2 iterations): gradients before the clip within
  1e-5 of the global norm (relative L2 over all tensors), ``train/loss``
  and ``train/grad_norm`` within rtol 1e-5, the updated parameters within
  atol 1e-5, the pixel counts equal; every rank's gradients, parameters
  and buffers bitwise rank 0's;
- test-mode forwards: within 1e-5 x flow scale;
- the transposed back-rotation and the per-batch-grid lookup: within 1e-6
  of the largest magnitude of the unsharded result.
The sharded taped step is also held to JAX's jitted standard step on the
same batch and weights at ``tests/test_torch_port_train.py``'s tolerance
(loss rtol 1e-4, the AdamW update within 1e-2 of the first learning
rate where the gradient is clearly above Adam's eps).

Inputs are seeded numpy arrays. The ranks run ``_rank_cases`` of this
module, which imports JAX only inside the fixture that needs it.
"""

import concurrent.futures
import math
import os

import numpy as np
import pytest
import torch

from prior_flow_tpu_torch.cli import train as tcli
from prior_flow_tpu_torch.geometry import grids as gridlib
from prior_flow_tpu_torch.models import build_model, build_raft
from prior_flow_tpu_torch.ops.corr import DCCL, all_pairs_correlation, \
    build_pyramid
from prior_flow_tpu_torch.ops.static_resample import (
    resample_static, resample_static_transpose)
from prior_flow_tpu_torch.parallel import dryrun, spatial
from prior_flow_tpu_torch.train import make_optimizer, make_train_step

HW = dryrun.DRYRUN_HW
ITERS = 2
SHAPE = (1, 2)
LAYER_TOL = 1e-6          # of the unsharded result's largest magnitude
FLOW_TOL = 1e-5           # x flow scale
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
JAX_LOSS_RTOL = 1e-4      # tests/test_torch_port_train.py's
JAX_UPDATE_ATOL = 1e-2    # x the first learning rate, as there
JAX_LR, JAX_NUM_STEPS = 4e-4, 100
STEPS = {"taped": (dict(grad_mode="taped"), dict(remat=False)),
         "taped_remat": (dict(grad_mode="taped"), {}),
         "deferred": ({}, dict(deferred_vol_grad=True)),
         "bn_batch_stats": ({}, dict(remat=False, bn_running_average=False))}
FORWARDS = {"mxu": (dict(lookup_mode="mxu"), False),
            "gather": (dict(lookup_mode="gather"), False),
            "bn_batch_stats": (dict(bn_running_average=False), False),
            "raft_basic": ({}, True),
            "raft_small": (dict(small=True), True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``test_torch_port_space.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _transpose_case():
    """A seeded cotangent of the 1/8 back-rotation's output and an input,
    at the 64x128 model's 1/8 grid."""
    g = gridlib.rotation_grids(*HW).to_device("cpu")
    h8, w8 = HW[0] // 8, HW[1] // 8
    rng = np.random.default_rng(21)
    return g.b2a_8, _np(rng, (2, h8, w8, 5)), _np(rng, (2, h8, w8, 5))


def _dccl_case():
    """Seeded inputs of one ``DCCL`` branch call with per-batch grids: the
    coords, both pyramids (the rank's query rows against whole targets
    are cut from these) and the two grids, each (B, h8, w8, 2)."""
    g = gridlib.rotation_grids(*HW).to_device("cpu")
    h8, w8 = HW[0] // 8, HW[1] // 8
    rng = np.random.default_rng(22)
    f1, f2, f3 = (_np(rng, (2, h8, w8, 8)) for _ in range(3))
    coords = (gridlib.identity_grid_on(h8, w8, "cpu")[None]
              + 2.0 * _np(rng, (2, h8, w8, 2)))
    jitter = lambda t: t[None] + 0.1 * _np(rng, (2, *t.shape))
    return coords, (f1, f2, f3), jitter(g.a2b_w2c_8), jitter(g.b2a_8)


def _dccl_call(coords, fmaps, w2c, back, space=None):
    """``DCCL('gather')``'s own and cross fields for the rank's rows of
    ``coords`` (under ``space``; the whole image without)."""
    f1, f2, f3 = fmaps
    if space is not None:
        coords, f1, f3 = (spatial.rows(t, space, 1) for t in (coords, f1, f3))
    pyr_own = build_pyramid(all_pairs_correlation(f1, f2), 3)
    pyr_other = build_pyramid(all_pairs_correlation(f3, f2), 3)
    with spatial.scope(space):
        return DCCL(3, lookup_mode="gather")(coords, pyr_own, pyr_other,
                                             w2c, back)


def _jax_step(mesh, state_dict, batch) -> dict:
    """The recipe's step (clip 1, AdamW at ``JAX_LR``) in the taped mode
    on this rank's rows of ``batch``, from ``state_dict``: the loss and
    the parameters after it."""
    from prior_flow_tpu_torch.parallel.mesh import shard_batch
    model = build_model("cpu", state_dict=state_dict,
                        precision="highest").train()
    opt, sched = make_optimizer(model.parameters(), JAX_LR, JAX_NUM_STEPS)
    step = make_train_step(model, opt, sched, iters=ITERS,
                           grad_mode="taped", mesh=mesh)
    metrics = step(shard_batch(batch, mesh), 0)
    return dict(loss=float(metrics["train/loss"]),
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def _rank_cases(mesh, batch, jax_sd, jax_batch):
    """Every case on this rank: the steps, the forwards, the transposed
    back-rotation, the per-batch-grid lookup and the taped step from
    JAX's weights."""
    space = mesh.space
    kw = dict(precision="highest")
    out = {"steps": {
        name: dryrun.rank_updates(mesh, [dict(case, iters=ITERS)], batch, 1,
                                  0, dict(kw, **model_kw))[0]
        for name, (case, model_kw) in STEPS.items()}}
    out["forward"] = {
        name: dryrun.forward_rows(mesh, [(*batch[:2], ITERS)], 0, 1, model_kw,
                                  raft)[0]["flow"]
        for name, (model_kw, raft) in FORWARDS.items()}
    grid, ct, x = _transpose_case()
    h = ct.shape[1] // space.size
    with spatial.scope(space):
        t_rows = resample_static_transpose(spatial.rows(ct, space, 1), grid,
                                           (h, ct.shape[2]))
        y_rows = resample_static(spatial.rows(x, space, 1), grid)
    # <resample(x), ct> and <x, transpose(ct)> over this rank's rows
    dots = torch.stack([(y_rows.double() * spatial.rows(ct, space, 1)).sum(),
                        (spatial.rows(x, space, 1).double() * t_rows).sum()])
    out["transpose"] = (t_rows, spatial.sum_over_space(dots, space))
    out["dccl"] = _dccl_call(*_dccl_case(), space=space)
    out["jax"] = _jax_step(mesh, jax_sd, jax_batch)
    return out


def _cli_tree(root) -> str:
    """An MPF tree for the training CLI: the EFT training split
    (``EFTs_Car2000``), 3 frames at 64x128 (``tests/test_data.py``'s
    writer)."""
    from test_data import _make_mpf_tree
    _make_mpf_tree(str(root), n=3, H=HW[0], W=HW[1])
    os.rename(os.path.join(str(root), "EFTs_Car100"),
              os.path.join(str(root), "EFTs_Car2000"))
    return str(root)


def _cli_run(root) -> list:
    """``cli.train --mesh 1x2 --grad_mode taped --device cpu`` for one
    update, where ``mesh_ranks`` finds two devices (as two cards, or
    torchrun's two ranks, would give): ``main`` spawns the two ranks
    itself. Returns the checkpoint tags."""
    save = os.path.join(str(root), "ckpt")
    argv = ["--mesh", "1x2", "--grad_mode", "taped", "--device", "cpu",
            "--stage", "EFT", "--data_root", _cli_tree(root / "mpf"),
            "--batch_size", "2", "--iters", "1", "--num_steps", "0",
            "--save_path", save]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "mesh_ranks", lambda spec, device=None: (2, False))
        # the ranks were spawned processes
        assert tcli.main(argv) is None
    return sorted(os.listdir(save))


def _jax_oracle():
    """JAX's jitted standard step (``tests/test_torch_port_train.py``'s
    oracle: half-scale random weights, its batch) and the port's state
    dict of the same weights."""
    import jax.numpy as jnp
    import optax
    import test_torch_port_train as ttrain
    from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
    from prior_flow_tpu.train import optim as joptim
    from prior_flow_tpu.train import trainer as jtrainer
    from prior_flow_tpu_torch.checkpoint import state_dict_from_jax
    import jax

    jm = JaxPriOrRAFT(precision="highest")
    variables = ttrain._variables(jm, seed=3)
    sd = state_dict_from_jax(variables)
    batch = ttrain._batch()

    def run():
        tx, schedule = joptim.make_optimizer(JAX_LR, JAX_NUM_STEPS)
        tx = optax.chain(ttrain._capture_grads(), tx)
        state = jtrainer.TrainState.create(variables, tx)
        step = jax.jit(jtrainer.make_train_step(jm, tx, iters=ITERS,
                                                gamma=0.8))
        new, metrics = step(state, tuple(jnp.asarray(a) for a in batch),
                            jax.random.PRNGKey(0))
        as_np = lambda tree: {k: v.numpy() for k, v in state_dict_from_jax(
            {"params": tree}).items()}
        return dict(loss=float(metrics["train/loss"]),
                    grad_norm=float(metrics["train/grad_norm"]),
                    grads=as_np(new.opt_state[0]), old=as_np(state.params),
                    new=as_np(new.params), lr0=float(schedule(0)))

    return sd, tuple(torch.from_numpy(a) for a in batch), run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The pool's results, the CLI's checkpoint tags, JAX's step and this
    process's references."""
    batch = dryrun.synthetic_batch(3, 2, *HW)
    jax_sd, jax_batch, jax_run = _jax_oracle()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(dryrun.spawn, _rank_cases, 2, batch, jax_sd,
                            jax_batch, device="cpu", shape=SHAPE)
        cli = pool.submit(_cli_run, tmp_path_factory.mktemp("cli"))
        jax_ref = pool.submit(jax_run)
        kw = dict(precision="highest")
        refs = {"steps": {
            name: dryrun.train_once(None, "cpu", dict(case, iters=ITERS),
                                    batch, **kw, **model_kw)
            for name, (case, model_kw) in STEPS.items()}}
        refs["forward"] = {
            name: (build_raft if raft else build_model)(
                "cpu", seed=0, **model_kw)(*batch[:2], iters=ITERS)
            for name, (model_kw, raft) in FORWARDS.items()}
        grid, ct, x = _transpose_case()
        refs["transpose"] = resample_static_transpose(ct, grid, ct.shape[1:3])
        refs["dccl"] = _dccl_call(*_dccl_case())
        out = dict(refs=refs, ranks=ranks.result(), cli=cli.result(),
                   jax=jax_ref.result())
    return out


def _whole(ranks, rows_of):
    """A global (B, H, ...) tensor from the two ranks' rows."""
    return torch.cat([rows_of(r) for r in ranks], dim=1)


def _close(got, want, tol):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, tol)
    return err


def _global_norm(tensors):
    return math.sqrt(sum(float((t.double() ** 2).sum())
                         for t in tensors.values()))


@pytest.mark.parametrize("name", STEPS)
def test_sharded_step_is_the_one_process_step(runs, name):
    """The taped step (remat off and on), the deferred step and the
    batch-statistics step, height-sharded over 2 ranks, against one
    process's step on the whole batch: gradients before the clip, loss,
    grad norm, updated parameters, running statistics and pixel counts;
    every rank's gradients, parameters and buffers bitwise rank 0's."""
    ref, ranks = runs["refs"]["steps"][name], runs["ranks"]
    got = ranks[0]["steps"][name]
    assert all(r["steps"][name][f"{k}_same"] for r in ranks
               for k in ("grads", "params", "buffers"))
    g, want = got["grads"], ref["grads"]
    assert g.keys() == want.keys()
    dist_ = _global_norm({k: g[k] - want[k] for k in want})
    norm = _global_norm(want)
    print(f"{name}: gradients {dist_ / norm:.3e} of the global norm")
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
    for k, b in ref["buffers"].items():
        torch.testing.assert_close(got["buffers"][k], b, atol=PARAM_ATOL,
                                   rtol=LOSS_RTOL)
    if name == "bn_batch_stats":   # the step moved the running statistics
        moved = [k for k, b in ref["buffers"].items()
                 if k.startswith("cnet.") and k.endswith("running_mean")
                 and b.abs().max() > 0]
        assert moved


@pytest.mark.parametrize("name", FORWARDS)
def test_sharded_forward_is_the_one_process_forward(runs, name):
    """The 64x128, 2-iteration test-mode forwards of the ``mxu`` and
    ``gather`` lookups, batch statistics, and RAFT basic and small: the
    ranks' rows within 1e-5 x flow scale of the one-process flow."""
    want = runs["refs"]["forward"][name]
    flow = _whole(runs["ranks"], lambda r: r["forward"][name])
    err = _close(flow, want, FLOW_TOL)
    print(f"{name}: {err:.3e} of flow scale {want.abs().max().item():.3f}")


def test_sharded_transposed_back_rotation(runs):
    """``resample_static_transpose`` under a space scope at the rank's
    rows (``src_hw``) is the transpose of the sharded resample: its rows
    are those of the whole-image transpose, and <resample(x), ct> equals
    <x, transpose(ct)> summed over the ranks."""
    want = runs["refs"]["transpose"]
    got = _whole(runs["ranks"], lambda r: r["transpose"][0])
    _close(got, want, LAYER_TOL)
    lhs, rhs = runs["ranks"][0]["transpose"][1].tolist()
    assert rhs == pytest.approx(lhs, rel=1e-6)


def test_sharded_per_batch_grid_lookup(runs):
    """``DCCL('gather')`` with per-batch grids (the back-rotation by
    ``cycle_bilinear_sample``): the ranks' own and cross rows against the
    unsharded call."""
    for i, want in enumerate(runs["refs"]["dccl"]):
        got = _whole(runs["ranks"], lambda r: r["dccl"][i])
        _close(got, want, LAYER_TOL)


def test_cli_trains_taped_on_a_space_mesh(runs):
    """``cli.train --mesh 1x2 --grad_mode taped --device cpu``: two spawned
    ranks take one update and rank 0 writes ``final`` and its log."""
    assert runs["cli"] == ["final", "logs"]


def test_sharded_taped_step_matches_jax(runs):
    """The taped step, height-sharded over 2 ranks from JAX's weights,
    against JAX's jitted standard step on the same batch: the loss and
    the AdamW update, as ``tests/test_torch_port_train.py`` holds the
    one-process step."""
    ref, got = runs["jax"], runs["ranks"][0]["jax"]
    assert abs(got["loss"] - ref["loss"]) <= JAX_LOSS_RTOL * abs(ref["loss"])
    worst = 0.0
    clip = min(1.0, 1.0 / ref["grad_norm"])
    for n, p in got["params"].items():
        # where the clipped gradient is clearly above Adam's eps
        mask = np.abs(ref["grads"][n] * clip) > 1e-6
        d_got = (p.numpy() - ref["old"][n])[mask]
        d_ref = (ref["new"][n] - ref["old"][n])[mask]
        err = float(np.abs(d_got - d_ref).max()) if d_got.size else 0.0
        assert err <= JAX_UPDATE_ATOL * ref["lr0"], n
        worst = max(worst, err)
    print(f"sharded taped step vs JAX: loss {got['loss']:.6f} (jax "
          f"{ref['loss']:.6f}), worst update error {worst:.3e} (lr0 "
          f"{ref['lr0']:.3e})")
