"""Data-parallel training of the port (``prior_flow_tpu_torch.parallel``,
``make_train_step(mesh=)``, ``Trainer(mesh=)``, the loader's rank rows,
``cli.train --mesh``) on the CPU over gloo.

The oracle is the port's own single-process step, which
``tests/test_torch_port_train.py`` holds to JAX's, as JAX's
``tests/test_train_parallel.py:97-148`` holds its SPMD step to the
single-device one. Tolerances:
- world 1 against no mesh: bitwise (a one-rank all-reduce is the
  identity);
- two ranks' gradients before the clip against the in-process sum of the
  two ranks' shares (``parallel.dryrun.RankShare``): bitwise (a sum of
  two f32 values is the same in any order);
- two ranks against the batch-2 step: gradients within 1e-5 of its global
  norm (relative L2 over all tensors), ``train/grad_norm`` and the loss
  within rtol 1e-5, the updated parameters within JAX's atol 1e-5, the
  pixel-count metrics equal and the EPE within rtol 1e-5 (f32 sums over
  other batch splits).

Ranks are spawned processes (``parallel.dryrun.spawn``) meeting through a
``file://`` store in a temp directory; the in-process mesh uses one under
``tmp_path``.
"""

import concurrent.futures
import datetime
import math
import os

import numpy as np
import pytest
import torch

from prior_flow_tpu_torch.cli import train as tcli
from prior_flow_tpu_torch.data.loader import DataLoader
from prior_flow_tpu_torch.parallel import dryrun, mesh as pmesh
from prior_flow_tpu_torch.train import (Trainer, TrainerConfig,
                                        make_optimizer, make_train_step)

GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
HW = dryrun.DRYRUN_HW
CASES = [dict(grad_mode="standard"), dict(grad_mode="taped"),
         dict(grad_mode="standard", noise=True, dropout=0.1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in ``test_torch_port_scale.py``: the suite's
    worker processes share the cores (spawned ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mesh1(tmp_path):
    """A one-rank gloo mesh in this process."""
    mesh = pmesh.make_mesh(1, device="cpu",
                           init_method=f"file://{tmp_path / 'store'}", rank=0)
    yield mesh
    pmesh.close_mesh(mesh)


def _steps(mesh, case, batches):
    """Updates of a seeded model on ``batches``: (metrics, params) per
    update."""
    from prior_flow_tpu_torch import build_model
    model = build_model("cpu", seed=0, dropout=case.get("dropout", 0.0)
                        ).train()
    opt, sched = make_optimizer(model.parameters(), 1e-4, 100)
    step = make_train_step(model, opt, sched, iters=2,
                           grad_mode=case["grad_mode"],
                           noise=case.get("noise", False), mesh=mesh)
    out = []
    for k, batch in enumerate(batches):
        m = step(batch, k)
        out.append(({n: v.clone() for n, v in m.items()},
                    [p.detach().clone() for p in model.parameters()]))
    return out


def test_world_1_is_bitwise_the_meshless_step_and_run(mesh1, tmp_path):
    """A one-rank gloo mesh: ``mesh.shape == {"data": 1}``; two updates of
    the step with noise and dropout, and ``Trainer.run`` for two updates,
    bitwise equal to the same without a mesh."""
    assert mesh1.shape == {"data": 1} and mesh1.backend == "gloo"
    case = dict(grad_mode="standard", noise=True, dropout=0.1)
    batches = [dryrun.synthetic_batch(s, 1, *HW) for s in (1, 2)]
    for (m0, p0), (m1, p1) in zip(_steps(None, case, batches),
                                  _steps(mesh1, case, batches)):
        assert m0.keys() == m1.keys()
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
        assert all(torch.equal(a, b) for a, b in zip(p0, p1))

    def run(mesh, tag):
        cfg = TrainerConfig(num_steps=1, batch_size=1, iters=2,
                            save_path=str(tmp_path / tag), val_freq=10 ** 9)
        seen = []
        trainer = Trainer(cfg, device="cpu", mesh=mesh,
                          logger=lambda m, s: seen.append((s, m)))
        loader = DataLoader(dryrun.SyntheticPairs(2), batch_size=1,
                            shuffle=False, num_workers=0)
        trainer.run(loader)
        assert trainer.step == 2 and os.listdir(cfg.save_path) == ["final"]
        return seen, [p.detach() for p in trainer.model.parameters()]

    (l0, q0), (l1, q1) = run(None, "plain"), run(mesh1, "mesh")
    for logged in (l0, l1):     # a host-clock rate, not a result
        assert len(logged) == 1
        logged[0][1].pop("train/steps_per_sec")
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(q0, q1))


def _global_norm(grads):
    return math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in grads.values()))


def test_two_ranks_are_the_global_batch_step():
    """Two spawned gloo ranks at 64x128, 2 iterations, a global batch of 2,
    in the standard and taped modes and with noise and dropout: every
    rank's gradients before the clip are bitwise the in-process sum of
    both ranks' shares; gradients, grad norm, loss, updated parameters
    and metrics match the batch-2 step; both ranks' parameters after the
    update are bitwise equal."""
    batch = dryrun.synthetic_batch(3, 2, *HW)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the ranks run in their processes while this one computes the
        # references
        spawned = pool.submit(dryrun.spawn, dryrun.rank_updates, 2, CASES,
                              batch, device="cpu")
        refs = [(dryrun.shares_summed(2, "cpu", case, batch),
                 dryrun.train_once(None, "cpu", case, batch))
                for case in CASES]
        ranks = spawned.result()
    for i, (case, ((shares, loss), ref)) in enumerate(zip(CASES, refs)):
        got = ranks[0][i]
        assert all(r[i]["grads_same"] and r[i]["params_same"] for r in ranks)
        assert got["metrics"]["train/loss"] == loss
        assert got["grads"].keys() == shares.keys() == ref["grads"].keys()
        for k, g in shares.items():
            assert torch.equal(got["grads"][k], g), (case, k)
        norm = _global_norm(ref["grads"])
        dist = _global_norm({k: got["grads"][k] - g
                             for k, g in ref["grads"].items()})
        print(f"{case}: gradients {dist / norm:.3e} of the batch-2 step's "
              f"norm")
        assert dist <= GRAD_RTOL * norm, case
        for k in ("train/loss", "train/grad_norm", "A-epe", "B-epe"):
            assert got["metrics"][k] == pytest.approx(ref["metrics"][k],
                                                      rel=LOSS_RTOL), (case, k)
        for k, v in ref["metrics"].items():
            if k.endswith("px"):
                assert got["metrics"][k] == v, (case, k)
        for k, p in ref["params"].items():
            torch.testing.assert_close(got["params"][k], p, atol=PARAM_ATOL,
                                       rtol=0)


def test_loader_rank_rows_make_the_global_batch():
    """The union of the ranks' batches is the global batch, bitwise, from
    the start and resumed at a later batch across an epoch boundary; a
    batch that does not split over the ranks raises."""
    ds = dryrun.SyntheticPairs(6, h=8, w=16)
    loader = DataLoader(ds, batch_size=4, shuffle=True, num_workers=0,
                        seed=7)
    for start in (0, 3):
        whole = loader.infinite(start_batch=start)
        parts = [loader.infinite(start_batch=start, rank=r, world=2)
                 for r in range(2)]
        for _ in range(3):
            want = next(whole)
            rows = [next(p) for p in parts]
            for j, t in enumerate(want):
                assert torch.equal(torch.cat([r[j] for r in rows]), t)
    with pytest.raises(ValueError, match="does not split"):
        next(DataLoader(ds, batch_size=3, num_workers=0).infinite(
            rank=0, world=2))


def test_only_rank_0_logs_and_writes(tmp_path):
    """Rank 1 of 2 (``RankShare``: no collectives) trains but logs and
    writes nothing; rank 0 logs and writes ``final``."""
    for rank in (0, 1):
        cfg = TrainerConfig(num_steps=0, batch_size=2, iters=1,
                            save_path=str(tmp_path / str(rank)),
                            val_freq=1)
        seen = []
        trainer = Trainer(cfg, mesh=dryrun.RankShare(rank, 2, "cpu"),
                          logger=lambda m, s: seen.append(s),
                          validators={})
        trainer.run([dryrun.synthetic_batch(0, 2, *HW)])
        assert trainer.step == 1
        wrote = sorted(os.listdir(cfg.save_path)) if os.path.isdir(
            cfg.save_path) else []
        assert (seen, wrote) == (([0], ["1", "final"]) if rank == 0
                                 else ([], [])), rank


def test_mesh_flag(monkeypatch):
    """``--mesh`` as the JAX CLI reads it: ``auto`` is every visible card
    (torchrun's world size under torchrun, 1 with ``--device cpu``);
    ``DPxSP`` must match it (DP x SP ranks), with JAX's message;
    malformed specs get JAX's message."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tcli.mesh_ranks("auto", "cpu") == (1, False)
    assert tcli.mesh_ranks("1x1", "cpu") == (1, False)
    with pytest.raises(SystemExit, match=r"2x1=2 chips requested but 1 "
                                         r"visible"):
        tcli.mesh_ranks("2x1", "cpu")
    with pytest.raises(SystemExit, match=r"1x2=2 chips requested but 1 "
                                         r"visible"):
        tcli.mesh_ranks("1x2", "cpu")
    with pytest.raises(SystemExit, match="expects 'auto' or 'DPxSP'"):
        tcli.mesh_ranks("2by1", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tcli.mesh_ranks("auto", "cpu") == (2, True)
    assert tcli.mesh_ranks("2x1", None) == (2, True)
    assert tcli.mesh_ranks("1x2", None) == (2, True)
    with pytest.raises(SystemExit, match="4 chips requested but 2 visible"):
        tcli.mesh_ranks("4x1", None)
    with pytest.raises(SystemExit, match="1 chips requested but 2 visible"):
        tcli.mesh_ranks("1x1", "cpu")


def test_failed_rendezvous_raises(tmp_path):
    """Rank 0 of 2 with no rank 1: the rendezvous times out and raises; no
    group is left behind to train on alone."""
    import torch.distributed as dist
    with pytest.raises(Exception) as err:
        pmesh.make_mesh(2, device="cpu", rank=0,
                        init_method=f"file://{tmp_path / 'store'}",
                        timeout=datetime.timedelta(seconds=3))
    print(f"{type(err.value).__name__}: {str(err.value)[:200]}")
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("make_mesh left a process group after a failed "
                    "rendezvous")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_ranks_default_to_the_card():
    """``spawn`` and ``dryrun_multichip`` put one rank on each card unless
    the CPU is asked for: without a card they raise before any rank
    starts."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.spawn(dryrun.rank_updates, 2, [], None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.dryrun_multichip(2)


def test_dryrun_multichip(capfd):
    """The port's ``dryrun_multichip(2)``: ``Trainer.run`` for 2 updates on
    two gloo ranks; JAX's ok line with ``mesh={'data': 2}``."""
    res = dryrun.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2): ok, mesh={'data': 2}, Trainer.run 2 steps" \
        in out
    assert np.isfinite(res["loss"]) and res["step"] == 2
