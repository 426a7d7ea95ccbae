"""Uneven heights on the space axis and batch statistics across a data-only
mesh (``parallel/spatial.py``'s strips, ``Mesh.step_space``), on the CPU
over gloo.

Any height JAX's ``P('data', 'space')`` takes shards: a multiple of 8 and
of S. Space rank r holds the strip of rows [r n, (r + 1) n), n = 8 *
ceil(H / (8 S)), the rows past H padding; 72 rows (H / 8 = 9) split into
40 + 32 over S = 2, and 24 rows into 8 + 8 + 8 + 0 over S = 4 (an all-pad
strip). The oracle is the port's own one-process result, which
``tests/test_torch_port_model.py`` and ``..._train.py`` hold to JAX's, and
JAX's jitted forward on ``make_mesh_2d(1, 2)`` itself. Three pools of
spawned gloo ranks run every case once (``_space_cases``, ``_layer_cases``,
``_data_cases``) while this process computes the references and JAX's
side. Tolerances (``tests/test_torch_port_space.py``'s):
- every convolution geometry of the encoders and update blocks, the
  instance norm, the group norm and the batch-statistics BatchNorm at 24
  rows over S = 2 and 4, their pad rows filled with 1e3: forward and both
  gradients within 1e-6 of the unsplit layer's largest magnitude (the
  convolutions in float64, split and unsplit), and no input gradient on
  a pad row;
- the 72x128, 2-iteration test-mode forward (volume and on the fly, from
  JAX's weights) and the legacy RAFT basic forward: within 1e-5 x flow
  scale of one process; the volume forward also within
  ``test_torch_port_model.py``'s 1e-3 x flow scale of JAX's jitted forward
  on ``make_mesh_2d(1, 2)``;
- the standard and taped steps at 72x128, batch 2: gradients before the
  clip within 1e-5 of the global norm (relative L2 over all tensors),
  ``train/loss`` within rtol 1e-5, the updated parameters within atol
  1e-5, the pixel counts equal; every rank's gradients, parameters and
  buffers bitwise rank 0's;
- the batch-statistics step on a data-only mesh of two ranks (64x128):
  gradients within 1e-5 of the global norm, running statistics within
  1e-6 of one process's and bitwise equal on both ranks; its training
  forward from JAX's weights against JAX's jitted
  ``apply(..., mutable=["batch_stats"])`` on a 2-device ``P('data')``
  mesh: the flows within 1e-3 x flow scale, the new statistics within
  ``test_torch_port_raft.py``'s rtol / atol 1e-5; a frozen-BatchNorm step
  there calls the data-parallel step's three all-reduces and no more.

The batches. The data-only step takes the other space modules' batch,
``synthetic_batch(3, ...)`` at 64x128. At 72x128 that batch puts ReLUs on
their kink: the split's f32 rounding flips them, the sharded step lies
5.3e-5 of the norm from one process's, and one process moves 7.2e-5 when
its images move by 1e-4 grey levels. So the 72x128 steps take
``synthetic_batch(0, ...)`` (3.2e-7 there), and seed 3's batch is kept as
a case of its own, held to that nudged distance (ROADMAP Queue 3, "Kept
on purpose"). Seed 0's batch is such a batch for the batch-statistics
step at 64x128 (3.3e-4 from one process on a data-only mesh and on a 1x2
space mesh alike).

Inputs are seeded numpy arrays. The ranks run this module's workers; it
imports JAX only inside the fixture that needs it. Alone it takes ~2 min.
"""

import collections
import concurrent.futures
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from prior_flow_tpu_torch.models import build_model, build_raft
from prior_flow_tpu_torch.nn.layers import (BatchNorm, Conv2d, GroupNorm,
                                            InstanceNorm)
from prior_flow_tpu_torch.parallel import dryrun, spatial
from prior_flow_tpu_torch.parallel.mesh import shard_batch
from prior_flow_tpu_torch.train import make_optimizer, make_train_step

HW = (72, 128)            # H / 8 = 9: 40 + 32 rows over S = 2
DATA_HW = dryrun.DRYRUN_HW
ITERS = 2
LAYER_TOL = 1e-6          # of the unsplit layer's largest magnitude
FLOW_TOL = 1e-5           # x flow scale, against one process
JAX_FLOW_TOL = 1e-3       # x flow scale, tests/test_torch_port_model.py's
STAT_TOL = 1e-6           # running statistics, against one process
JAX_STAT_TOL = 1e-5       # tests/test_torch_port_raft.py's rtol and atol
GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
PAD_FILL = 1e3            # what the layers' pad rows hold
NUDGE = 1e-4              # grey levels: the kink batch's yardstick
GEOMETRIES = [((7, 7), 2, (3, 3)), ((3, 3), 1, (1, 1)), ((3, 3), 2, (1, 1)),
              ((1, 1), 2, (0, 0)), ((1, 1), 1, (0, 0)), ((7, 7), 1, (3, 3)),
              ((1, 5), 1, (0, 2)), ((5, 1), 1, (2, 0))]
# B, C, H, W: 3 eighth-rows, strips of 16 rows at S = 2 (16 + 8 real)
# and of 8 at S = 4 (8 + 8 + 8 + 0: the last strip all padding)
LAYER_SHAPE = (2, 3, 24, 12)
FORWARDS = {"volume": (dict(precision="highest"), False),
            "onthefly": (dict(precision="highest", corr_mode="onthefly"),
                         False),
            "raft_basic": ({}, True)}
STEPS = {"standard": ({}, dict(remat=False)),
         "taped": (dict(grad_mode="taped"), dict(remat=False))}
BN = dict(remat=False, bn_running_average=False, precision="highest")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``test_torch_port_space.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _seeded(layer, seed: int, scale: float = 1.0, shift: float = 0.0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(_np(rng, p.shape) * scale + shift)
    return layer


def _layers():
    """Every layer case: (name, layer, input, output cotangent, batch). The
    convolutions run in float64, split and unsplit: their sharding is
    exact, and at 24 x 12 pixels f32's own rounding of the bias gradient
    (a sum of 576 products) moves it by up to 1.1e-6 of its magnitude
    from float64, split or not. The norms keep f32 (their statistics are
    f32 by design)."""
    rng = np.random.default_rng(30)
    x3 = _np(rng, LAYER_SHAPE) * 3.0 + 1.5
    x6 = torch.cat([x3, 0.5 * x3 - 2.0], 1)
    out = []
    for i, (kernel, stride, padding) in enumerate(GEOMETRIES):
        conv = _seeded(Conv2d(3, 5, kernel, stride=stride, padding=padding),
                       40 + i).double()
        with torch.no_grad():
            shape = torch.nn.Conv2d.forward(conv, x3.double()).shape
        out.append((f"conv{i}", conv, x3.double(),
                    _np(rng, shape).double(), False))
    out.append(("instance", InstanceNorm(), x3, _np(rng, x3.shape), False))
    out.append(("group", _seeded(GroupNorm(3, 6), 50, 0.5, 1.0), x6,
                _np(rng, x6.shape), False))
    out.append(("batch", _seeded(BatchNorm(6), 51, 0.5, 1.0), x6,
                _np(rng, x6.shape), True))
    return out


def _strip(t, space, fill: float):
    """This rank's strip of the whole NCHW ``t``: its real rows, then pad
    rows holding ``fill``."""
    real = spatial.shard_rows(t, space, 2)
    pad = t.new_full((*t.shape[:2], space.strip - real.shape[2],
                      t.shape[3]), fill)
    return torch.cat([real, pad], 2)


def _layer_cases(mesh, H: int):
    """A rank's worker: every layer on its strip at S = the mesh's space
    size: the output's and the input gradient's real rows, the input
    gradient's pad rows, the parameter gradients summed over the ranks
    and the buffers."""
    space = dataclasses.replace(mesh.space, height=H)
    out = {}
    for name, layer, x, ct, batch in _layers():
        x = _strip(x, space, PAD_FILL).requires_grad_()
        with spatial.scope(space):
            y = layer(x)
        y.backward(spatial.rows(ct, space, 2))
        r = space.real(x.shape[2])
        out[name] = dict(
            y=space.crop(y.detach(), 2), dx=x.grad[:, :, :r],
            dx_pad=x.grad[:, :, r:],
            grads=[space.all_reduce_(p.grad, batch)
                   for p in layer.parameters()],
            buffers=[b.clone() for b in layer.buffers()])
    return out


def _space_cases(mesh, forward_sd, pair, kink_batch):
    """A rank's worker on the 1x2 mesh: the layers, the forwards (and
    ``pair``'s, JAX's input), the steps (and the kink batch's standard
    step)."""
    batch = dryrun.synthetic_batch(0, 2, *HW)
    out = {"layers": _layer_cases(mesh, LAYER_SHAPE[2]), "forward": {}}
    for name, (kw, raft) in FORWARDS.items():
        kw = kw if raft else dict(kw, state_dict=forward_sd)
        out["forward"][name] = dryrun.forward_rows(
            mesh, [(*batch[:2], ITERS)], 0, 1, kw, raft)[0]["flow"]
    out["pair"] = dryrun.forward_rows(
        mesh, [(*pair, ITERS)], 0, 1,
        dict(state_dict=forward_sd, precision="highest"))[0]["flow"]
    out["steps"] = {
        name: dryrun.rank_updates(mesh, [dict(case, iters=ITERS)], batch, 1,
                                  0, model_kw)[0]
        for name, (case, model_kw) in STEPS.items()}
    out["kink"] = dryrun.rank_updates(
        mesh, [dict(iters=ITERS)], kink_batch, 1, 0, dict(remat=False))[0]
    return out


def _collectives(mesh, batch, bn: bool) -> dict:
    """The collectives one step on ``mesh`` calls, by name, with frozen
    BatchNorm or batch statistics."""
    model = build_model("cpu", seed=0, **(BN if bn else {})).train()
    opt, sched = make_optimizer(model.parameters(), 1e-4, 100)
    step = make_train_step(model, opt, sched, iters=ITERS, mesh=mesh)
    rows = shard_batch(batch, mesh)
    counts = collections.Counter()
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast", "all_gather", "barrier")
    originals = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return originals[name](*args, **kwargs)
        return call

    try:
        for n in names:
            setattr(dist, n, counted(n))
        step(rows, 0)
    finally:
        for n, f in originals.items():
            setattr(dist, n, f)
    return dict(counts)


def _data_cases(mesh, jax_sd, images):
    """A rank's worker on the data-only mesh of two ranks: the
    batch-statistics step, the training forward from JAX's weights on
    this rank's batch rows (its flows and running statistics), and the
    collectives of a step with frozen BatchNorm and with batch
    statistics."""
    batch = dryrun.synthetic_batch(3, 2, *DATA_HW)
    step = dryrun.rank_updates(mesh, [dict(iters=ITERS)], batch, 1, 0, BN)[0]
    model = build_model("cpu", state_dict=jax_sd, **BN)
    rows = shard_batch(images, mesh)
    with torch.no_grad(), spatial.scope(mesh.step_space):
        preds = model(*rows, iters=ITERS, test_mode=False)
    return dict(step=step, preds=preds,
                stats={k: b.clone() for k, b in model.state_dict().items()
                       if "running" in k},
                collectives={bn: _collectives(mesh, batch, bn)
                             for bn in (False, True)})


def _jax(H: int, W: int):
    """JAX's side: random variables of the precision-"highest" model and
    of the batch-statistics one, the port's state dicts of them, and a
    function computing (a) the jitted test-mode forward on a 72x128 pair
    sharded ``P('data', 'space')`` over ``make_mesh_2d(1, 2)`` and (b)
    the jitted training forward with ``mutable=["batch_stats"]`` on a
    64x128 batch of 2 sharded ``P('data')`` over 2 devices."""
    import jax
    import jax.numpy as jnp
    from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
    from prior_flow_tpu.parallel import mesh as jmesh
    from prior_flow_tpu_torch.checkpoint import state_dict_from_jax
    from test_torch_port_nn import random_variables

    img = jnp.zeros((1, *DATA_HW, 3))
    jm = JaxPriOrRAFT(precision="highest")
    v = random_variables(jm, img, img, iters=1)
    jm_bn = JaxPriOrRAFT(precision="highest", bn_running_average=False)
    v_bn = random_variables(jm_bn, img, img, iters=1, seed=1)
    pair = dryrun.synthetic_batch(0, 1, H, W)[:2]
    images = dryrun.synthetic_batch(5, 2, *DATA_HW)[:2]

    def run():
        m2 = jmesh.make_mesh_2d(1, 2)
        xs = [jax.device_put(jnp.asarray(t.numpy()),
                             jmesh.spatial_batch_sharding(m2)) for t in pair]
        fwd = jax.jit(lambda v, a, b: jm.apply(v, a, b, iters=ITERS,
                                               test_mode=True))
        flow = np.asarray(fwd(jax.device_put(v, jmesh.replicated(m2)), *xs))
        m1 = jmesh.make_mesh(2)
        xs = [jax.device_put(jnp.asarray(t.numpy()),
                             jmesh.batch_sharding(m1)) for t in images]
        train = jax.jit(lambda v, a, b: jm_bn.apply(
            v, a, b, iters=ITERS, test_mode=False,
            mutable=["batch_stats"]))
        (pa, pb), new = train(jax.device_put(v_bn, jmesh.replicated(m1)),
                              *xs)
        stats = {k: t for k, t in state_dict_from_jax(
            {**v_bn, **new}).items() if "running" in k}
        return dict(flow=torch.from_numpy(flow),
                    preds=(torch.from_numpy(np.asarray(pa)),
                           torch.from_numpy(np.asarray(pb))), stats=stats)

    return (state_dict_from_jax(v), state_dict_from_jax(v_bn), pair, images,
            run)


@pytest.fixture(scope="module")
def runs():
    """The three pools' results, JAX's side and this process's
    references."""
    sd, sd_bn, pair, images, jax_run = _jax(*HW)
    batch = dryrun.synthetic_batch(0, 2, *HW)
    kink = dryrun.synthetic_batch(3, 2, *HW)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        space = pool.submit(dryrun.spawn, _space_cases, 2, sd, pair, kink,
                            device="cpu", shape=(1, 2))
        wide = pool.submit(dryrun.spawn, _layer_cases, 4, LAYER_SHAPE[2],
                           device="cpu", shape=(1, 4))
        data = pool.submit(dryrun.spawn, _data_cases, 2, sd_bn, images,
                           device="cpu")
        jax_ref = pool.submit(jax_run)
        refs = {"forward": {}}
        for name, (kw, raft) in FORWARDS.items():
            model = (build_raft("cpu", seed=0, **kw) if raft else
                     build_model("cpu", state_dict=sd, **kw))
            refs["forward"][name] = model(*batch[:2], iters=ITERS)
        refs["pair"] = build_model("cpu", state_dict=sd,
                                   precision="highest")(*pair, iters=ITERS)
        refs["steps"] = {
            name: dryrun.train_once(None, "cpu", dict(case, iters=ITERS),
                                    batch, **kw)
            for name, (case, kw) in STEPS.items()}
        refs["kink"] = [dryrun.train_once(None, "cpu", dict(iters=ITERS), b,
                                          remat=False)
                        for b in (kink, (kink[0] + NUDGE, kink[1] - NUDGE,
                                         *kink[2:]))]
        refs["bn_step"] = dryrun.train_once(
            None, "cpu", dict(iters=ITERS),
            dryrun.synthetic_batch(3, 2, *DATA_HW), **BN)
        return dict(refs=refs, space=space.result(), wide=wide.result(),
                    data=data.result(), jax=jax_ref.result())


def _close(got, want, tol):
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, tol)
    return err


def _global_norm(tensors):
    return math.sqrt(sum(float((t.double() ** 2).sum())
                         for t in tensors.values()))


def _grad_distance(got, want):
    """The gradients' distance as a fraction of ``want``'s global norm."""
    assert got.keys() == want.keys()
    return (_global_norm({k: got[k] - want[k] for k in want})
            / _global_norm(want))


def _unsplit(name):
    """The unsplit layer's output, input gradient, parameter gradients and
    buffers."""
    for n, layer, x, ct, _ in _layers():
        if n == name:
            x = x.clone().requires_grad_()
            y = layer(x)
            y.backward(ct)
            return (y.detach(), x.grad, [p.grad for p in layer.parameters()],
                    [b.clone() for b in layer.buffers()])


@pytest.mark.parametrize("S", (2, 4))
@pytest.mark.parametrize("name", [f"conv{i}" for i in range(len(GEOMETRIES))]
                         + ["instance", "group", "batch"])
def test_uneven_layer_is_the_unsplit_layer(runs, name, S):
    """Each layer on strips of 24 rows (16 + 8 real at S = 2, 8 + 8 + 8 +
    0 at S = 4), pad rows full of 1e3: every rank's real output rows and
    input-gradient rows, the summed parameter gradients and the running
    statistics within 1e-6 of the unsplit layer's; pad rows get no
    gradient; the running statistics bitwise the same on every rank."""
    y, dx, grads, bufs = _unsplit(name)
    ranks = runs["space"] if S == 2 else runs["wide"]
    for r, res in enumerate(ranks):
        got = (res["layers"] if S == 2 else res)[name]
        space = spatial.Space(None, r, S, "gloo", height=LAYER_SHAPE[2])
        rows = lambda t: space.crop(spatial.rows(t, space, 2), 2)
        assert got["y"].shape == rows(y).shape
        if got["y"].numel():
            _close(got["y"], rows(y), LAYER_TOL)
            _close(got["dx"], rows(dx), LAYER_TOL)
        assert not got["dx_pad"].any()
        for g, want in zip(got["grads"], grads):
            _close(g, want, LAYER_TOL)
        first = (ranks[0]["layers"] if S == 2 else ranks[0])[name]
        for b, want, b0 in zip(got["buffers"], bufs, first["buffers"]):
            _close(b, want, LAYER_TOL)
            assert torch.equal(b, b0)


@pytest.mark.parametrize("name", FORWARDS)
def test_uneven_forward_is_the_one_process_forward(runs, name):
    """The 72x128, 2-iteration test-mode forwards, batch 2, over the 1x2
    mesh (40 + 32 rows): the ranks' rows, concatenated, within 1e-5 x flow
    scale of the one-process flow."""
    ranks = runs["space"]
    assert [r["forward"][name].shape[1] for r in ranks] == [40, 32]
    flow = torch.cat([r["forward"][name] for r in ranks], 1)
    want = runs["refs"]["forward"][name]
    err = _close(flow, want, FLOW_TOL)
    print(f"{name}: {err:.3e} of flow scale {want.abs().max().item():.3f}")


def test_uneven_forward_matches_jax_on_a_space_mesh(runs):
    """The sharded 72x128 forward from JAX's weights against JAX's jitted
    forward of the pair sharded ``P('data', 'space')`` over
    ``make_mesh_2d(1, 2)``: within 1e-3 x flow scale; and within 1e-5 of
    the port's one-process forward."""
    want = runs["jax"]["flow"]
    flow = torch.cat([r["pair"] for r in runs["space"]], 1)
    err = _close(flow, want, JAX_FLOW_TOL)
    _close(flow, runs["refs"]["pair"], FLOW_TOL)
    print(f"sharded 72x128 vs JAX on make_mesh_2d(1, 2): {err:.3e} of flow "
          f"scale {want.abs().max().item():.3f}")


def _check_step(got, ranks, ref, key):
    assert all(r[key][f"{k}_same"] for r in ranks
               for k in ("grads", "params", "buffers"))
    d = _grad_distance(got["grads"], ref["grads"])
    assert d <= GRAD_RTOL, d
    assert got["metrics"]["train/loss"] == pytest.approx(
        ref["metrics"]["train/loss"], rel=LOSS_RTOL)
    for k, v in ref["metrics"].items():
        if k.endswith("px"):
            assert got["metrics"][k] == v, k
    for k, p in ref["params"].items():
        torch.testing.assert_close(got["params"][k], p, atol=PARAM_ATOL,
                                   rtol=0)
    return d


@pytest.mark.parametrize("name", STEPS)
def test_uneven_step_is_the_one_process_step(runs, name):
    """The standard and taped steps at 72x128, batch 2, 2 iterations, over
    the 1x2 mesh: gradients, loss, updated parameters and pixel counts
    against one process's step; every rank's tensors bitwise rank 0's."""
    ranks = [{"step": r["steps"][name]} for r in runs["space"]]
    d = _check_step(ranks[0]["step"], ranks, runs["refs"]["steps"][name],
                    "step")
    print(f"{name}: gradients {d:.3e} of the global norm")


def test_uneven_step_on_a_kink_batch(runs):
    """Seed 3's batch at 72x128, where the split's rounding flips ReLUs on
    their kink: the sharded standard step lies no farther from one
    process's than one process moves when its images move by 1e-4 grey
    levels, and its loss and pixel counts are one process's."""
    ref, nudged = runs["refs"]["kink"]
    got = runs["space"][0]["kink"]
    d = _grad_distance(got["grads"], ref["grads"])
    yardstick = _grad_distance(nudged["grads"], ref["grads"])
    print(f"kink batch: gradients {d:.3e} of the norm; one process nudged "
          f"by {NUDGE} grey levels {yardstick:.3e}")
    assert d <= yardstick
    assert got["metrics"]["train/loss"] == pytest.approx(
        ref["metrics"]["train/loss"], rel=LOSS_RTOL)
    for k, v in ref["metrics"].items():
        if k.endswith("px"):
            assert got["metrics"][k] == v, k


def test_batch_statistics_step_on_a_data_only_mesh(runs):
    """Two ranks of a data-only mesh take the batch-statistics step at
    64x128 (one pair each): gradients within 1e-5 of the global norm of
    one process's step on the batch of 2, running statistics within 1e-6
    of its and bitwise equal on both ranks."""
    ranks = runs["data"]
    ref = runs["refs"]["bn_step"]
    d = _check_step(ranks[0]["step"], ranks, ref, "step")
    stats = {k: b for k, b in ref["buffers"].items() if "running" in k}
    moved = 0
    for k, b in stats.items():
        torch.testing.assert_close(ranks[0]["step"]["buffers"][k], b,
                                   atol=STAT_TOL, rtol=0)
        moved += not torch.equal(b, build_model("cpu", **BN).state_dict()[k])
    assert moved
    print(f"data-only batch statistics: gradients {d:.3e} of the norm")


def test_frozen_batchnorm_step_adds_no_collective(runs):
    """On the data-only mesh a step with frozen BatchNorm calls what the
    data-parallel step always has: three all-reduces (the gradient bucket,
    the metric sums, the loss); batch statistics add one all-reduce per
    norm in the forward and one in the backward (15 context-encoder norms),
    and no other collective."""
    for r in runs["data"]:
        frozen, batch = r["collectives"][False], r["collectives"][True]
        assert frozen == {"all_reduce": 3}
        assert batch == {"all_reduce": 3 + 2 * 15}


def test_batch_statistics_forward_matches_jax_on_a_data_mesh(runs):
    """The training forward of the batch-statistics model from JAX's
    weights, one pair on each of two data ranks, against JAX's jitted
    ``apply(..., mutable=["batch_stats"])`` of the batch of 2 sharded
    ``P('data')`` over 2 devices: both branches' flows within 1e-3 x flow
    scale, every new statistic within rtol / atol 1e-5 and bitwise the
    same on both ranks."""
    ranks, ref = runs["data"], runs["jax"]
    for i in range(2):
        got = torch.cat([r["preds"][i] for r in ranks], 1)
        _close(got, ref["preds"][i], JAX_FLOW_TOL)
    assert ref["stats"].keys() == ranks[0]["stats"].keys()
    for k, want in ref["stats"].items():
        for r in ranks:
            assert torch.equal(r["stats"][k], ranks[0]["stats"][k]), k
        np.testing.assert_allclose(ranks[0]["stats"][k].numpy(),
                                   want.numpy(), rtol=JAX_STAT_TOL,
                                   atol=JAX_STAT_TOL, err_msg=k)
