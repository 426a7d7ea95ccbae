"""The port's training loop and CLI against the JAX package's on the CPU.

- ``Trainer.run`` takes ``num_steps + 1`` updates, as JAX's loop does;
- ``add_noise``'s formula on JAX's own draws; dropout's semantics against
  flax's ``nn.Dropout`` (elementwise, rate p, kept values scaled by
  1 / (1 - p), identity outside training);
- ``cli.train`` end to end against JAX's ``cli.train`` on one synthetic
  EFT training tree (64x128, augmentation on, batch 1, 1 iteration,
  ``--num_steps 2``): each step's loss, the checkpoint tags, the JSONL
  keys; a run resumed from a checkpoint against the uninterrupted run;
- the FlyingThings graft against JAX's ``convert_things_ckpt`` followed by
  ``export_state_dict``; restore from a ``module.``-prefixed ``.pth``;
- the flag surface, the presets, the logger's records.

Tolerances: the per-step loss within 1e-4 relative of JAX's (the same
weights and batches; the two frameworks round differently). ``add_noise``
within one f32 spacing at 256 (3.05e-5): XLA may fuse the multiply and
add into one rounding where torch rounds twice. Everything else bitwise.
"""

import json
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from prior_flow_tpu.cli import train as jcli
from prior_flow_tpu.train import trainer as jtrainer
from prior_flow_tpu.utils import logger as jlogger
from prior_flow_tpu_torch.checkpoint import (convert_things_ckpt, load_pth,
                                             state_dict_from_jax, write_pth)
from prior_flow_tpu_torch.cli import train as tcli
from prior_flow_tpu_torch.models import build_model
from prior_flow_tpu_torch.nn.layers import dropout
from prior_flow_tpu_torch.train import (Trainer, TrainerConfig, add_noise,
                                        draw_noise, step_generator)
from prior_flow_tpu_torch.train import trainer as ttrainer
from prior_flow_tpu_torch.utils import logger as tlogger
from test_data import _make_mpf_tree

H, W = 64, 128
LOSS_RTOL = 1e-4
NOISE_ATOL = 2.0 ** -15       # one f32 spacing in [128, 256)


def _batches(n, b=1, h=32, w=64, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        i1, i2 = (torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(
            np.float32)) for _ in range(2))
        flow = torch.from_numpy((rng.normal(size=(b, h, w, 2)) * 4).astype(
            np.float32))
        out.append((i1, i2, flow, torch.ones(b, h, w)))
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic MPF tree: the EFT training split (5 frames, 4 pairs)
    and its test split (3 frames)."""
    root = str(tmp_path_factory.mktemp("mpf"))
    _make_mpf_tree(root, n=5, H=H, W=W)
    os.rename(osp.join(root, "EFTs_Car100"), osp.join(root, "EFTs_Car2000"))
    test = str(tmp_path_factory.mktemp("mpf_test"))
    _make_mpf_tree(test, n=3, H=H, W=W)
    os.rename(osp.join(test, "EFTs_Car100"), osp.join(root, "EFTs_Car100"))
    return root


# -- the loop ------------------------------------------------------------------------

def test_run_takes_num_steps_plus_one_updates(tmp_path):
    """JAX's loop runs ``while total_steps <= num_steps``, num_steps + 1
    updates, then saves ``final`` (``tests/test_trainer_e2e.py:44``); the
    port's took num_steps. Metrics are logged at step 0 only (every 100
    steps), with the rate and learning rate beside them."""
    logged = []
    cfg = TrainerConfig(num_steps=2, iters=1, seed=5,
                        save_path=str(tmp_path / "ck"))
    trainer = Trainer(cfg, device="cpu",
                      logger=lambda m, s: logged.append((s, m)))
    trainer.run(_batches(5))
    assert trainer.step == cfg.num_steps + 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["final"]
    assert [s for s, _ in logged] == [0]
    assert {"train/loss", "train/grad_norm", "train/steps_per_sec",
            "train/learning_rate"} <= set(logged[0][1])
    assert logged[0][1]["train/learning_rate"] == trainer.schedule(0)
    # a shorter iterable ends the run early, and it still saves final
    short = Trainer(cfg, device="cpu")
    short.run(_batches(2))
    assert short.step == 2


def test_add_noise_matches_jax_formula(rng):
    """``add_noise`` on JAX's own draws of ``make_train_step``
    (``prior_flow_tpu/train/trainer.py:230-237``) against JAX's expression,
    jitted as in the step; and the port's draws: stdv in [0, 5), keyed by
    (seed, step) alone."""
    i1 = rng.uniform(-20, 275, (2, 16, 32, 3)).astype(np.float32)
    i2 = rng.uniform(-20, 275, (2, 16, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    nrng, srng = jax.random.split(key)
    stdv = jax.random.uniform(srng, (), minval=0.0, maxval=5.0)
    n1 = jax.random.normal(nrng, i1.shape)
    n2 = jax.random.normal(jax.random.fold_in(nrng, 1), i2.shape)
    ref = jax.jit(lambda a, b, s, x, y: (
        jnp.clip(a + s * x, 0.0, 255.0), jnp.clip(b + s * y, 0.0, 255.0)))(
        i1, i2, stdv, n1, n2)
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = add_noise(t(i1), t(i2), t(stdv), t(n1), t(n2))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=NOISE_ATOL)
        assert g.min() >= 0 and g.max() <= 255

    image = t(i1)
    a = draw_noise(image, step_generator(3, 10, 0, "cpu"))
    b = draw_noise(image, step_generator(3, 10, 0, "cpu"))
    c = draw_noise(image, step_generator(3, 11, 0, "cpu"))
    assert 0.0 <= float(a[0]) < 5.0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1])
    assert a[1].shape == a[2].shape == image.shape
    assert not torch.equal(a[1], a[2])


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_semantics_match_flax(p):
    """Elementwise dropout at rate p: the zeroed share within 3 sigma of p
    and every kept value exactly x / (1 - p), as flax's ``nn.Dropout``
    computes them (held on its own draws too)."""
    import flax.linen as fnn
    x = np.random.default_rng(1).uniform(0.5, 2.0, (64, 64, 64)).astype(
        np.float32)
    got = dropout(torch.from_numpy(x), p, torch.Generator().manual_seed(0))
    ref = np.asarray(fnn.Dropout(rate=p, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)}))
    sigma = (p * (1 - p) / x.size) ** 0.5
    for out in (got.numpy(), ref):
        kept = out != 0
        assert abs((~kept).mean() - p) <= 3 * sigma
        np.testing.assert_array_equal(out[kept], (x / np.float32(1 - p))[kept])


def test_dropout_acts_only_in_the_training_forward():
    """In train mode the training forward drops out from the generator it
    is given (and raises without one); test mode and eval mode are the
    identity; p = 0 is bitwise the path without dropout."""
    i1, i2, _, _ = _batches(1, seed=2)[0]
    sd = build_model("cpu", seed=4).state_dict()
    plain = build_model("cpu", state_dict=sd).train()
    drop = build_model("cpu", state_dict=sd, dropout=0.2).train()
    gen = lambda: torch.Generator().manual_seed(9)
    with torch.no_grad():
        ref_A, _ = plain(i1, i2, iters=1, test_mode=False)
        zero_A, _ = plain(i1, i2, iters=1, test_mode=False, generator=gen())
        a, _ = drop(i1, i2, iters=1, test_mode=False, generator=gen())
        b, _ = drop(i1, i2, iters=1, test_mode=False, generator=gen())
        with pytest.raises(ValueError, match="generator"):
            drop(i1, i2, iters=1, test_mode=False)
        assert torch.equal(zero_A, ref_A)
        assert torch.equal(a, b) and not torch.equal(a, ref_A)
        assert torch.equal(drop(i1, i2, iters=1), plain(i1, i2, iters=1))
        drop.eval()
        e_A, _ = drop(i1, i2, iters=1, test_mode=False, generator=gen())
        assert torch.equal(e_A, ref_A)


def test_validate_runs_in_eval_mode_and_returns_to_training(tmp_path):
    seen = []

    def validator(model):
        seen.append((model.training, torch.is_grad_enabled()))
        return {"v-epe": 1.0}

    cfg = TrainerConfig(iters=1, num_steps=1, validation=("v",),
                        save_path=str(tmp_path))
    trainer = Trainer(cfg, device="cpu",
                      validators={"v": validator, "unused": validator})
    bn = {k: v.clone() for k, v in trainer.model.state_dict().items()
          if "running_" in k}
    trainer.train_step(_batches(1)[0])
    assert trainer.validate() == {"v-epe": 1.0}
    assert seen == [(False, False)] and trainer.model.training
    for k, v in trainer.model.state_dict().items():
        if "running_" in k:
            assert torch.equal(v, bn[k]), k      # the BatchNorm stays frozen


# -- the CLI end to end --------------------------------------------------------------

def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_matches_jax(tree, tmp_path, monkeypatch):
    """Both CLIs from one ``.pth`` on one augmented tree: every step's loss
    within 1e-4 relative, the same checkpoint tags, log files and step-0
    image panels, the same JSONL records (keys and steps). JAX sees one CPU
    device (no mesh)."""
    pth = str(tmp_path / "w.pth")
    torch.save(build_model("cpu", seed=3).state_dict(), pth)
    args = ["--stage", "EFT", "--data_root", tree, "--batch_size", "1",
            "--iters", "1", "--num_steps", "2", "--val_freq", "2",
            "--restore_ckpt", pth]

    d0 = jax.devices()[0]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [d0])
    ref_losses = []
    compile_step = jtrainer.Trainer.compile_step

    def recording_compile(self, state, batch):
        fn = compile_step(self, state, batch)

        def step(*a):
            new_state, m = fn(*a)
            ref_losses.append(float(m["train/loss"]))
            return new_state, m

        self._step_fn = step
        return step

    monkeypatch.setattr(jtrainer.Trainer, "compile_step", recording_compile)
    jdir = str(tmp_path / "jax")
    jcli.main(args + ["--save_path", jdir])

    losses = []
    train_step = ttrainer.Trainer.train_step

    def recording_step(self, batch):
        m = train_step(self, batch)
        losses.append(float(m["train/loss"]))
        return m

    monkeypatch.setattr(ttrainer.Trainer, "train_step", recording_step)
    tdir = str(tmp_path / "port")
    trainer = tcli.main(args + ["--save_path", tdir, "--device", "cpu"])

    assert trainer.step == 3 and len(losses) == len(ref_losses) == 3
    for got, ref in zip(losses, ref_losses):
        assert abs(got - ref) <= LOSS_RTOL * abs(ref), (losses, ref_losses)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "2", "final", "logs"]
    for sub in ("logs", osp.join("logs", "images")):
        assert sorted(os.listdir(osp.join(tdir, sub))) == sorted(
            os.listdir(osp.join(jdir, sub))), sub
    assert sorted(os.listdir(osp.join(tdir, "logs", "images"))) == [
        f"00000000_{k}.png" for k in ("flow_gt", "flow_pred_A",
                                      "flow_pred_B", "image1", "image1_B",
                                      "image2")]
    got, ref = (_jsonl(osp.join(d, "logs", "EFT.jsonl")) for d in (tdir, jdir))
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0]
    assert [set(r) for r in got] == [set(r) for r in ref]
    assert abs(got[0]["train/loss"] - ref[0]["train/loss"]) <= (
        LOSS_RTOL * abs(ref[0]["train/loss"]))
    # the checkpoint's model.pth is a reference-layout file
    sd = torch.load(osp.join(tdir, "final", "model.pth"), weights_only=True)
    assert all(k.startswith("module.") for k in sd)
    assert set(load_pth(osp.join(tdir, "final", "model.pth"))) == set(
        trainer.model.state_dict())


def test_resumed_run_equals_uninterrupted(tree, tmp_path):
    """A run resumed from its checkpoint at step 2 ends bitwise where the
    uninterrupted run ends: weights, optimizer moments and step, with
    augmentation, ``--add_noise``, dropout and four loader workers (the
    JAX counterpart: ``tests/test_trainer_e2e.py:51-100``)."""
    args = ["--stage", "EFT", "--data_root", tree, "--batch_size", "2",
            "--iters", "1", "--num_steps", "3", "--val_freq", "2",
            "--add_noise", "--dropout", "0.1", "--lr", "1e-3",
            "--device", "cpu"]
    full = tcli.main(args + ["--save_path", str(tmp_path / "full")])
    assert sorted(os.listdir(tmp_path / "full")) == ["2", "4", "final",
                                                     "logs"]
    resumed = tcli.main(args + ["--save_path", str(tmp_path / "resumed"),
                                "--restore_ckpt",
                                str(tmp_path / "full" / "2")])
    assert resumed.step == full.step == 4
    for (n, a), b in zip(full.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = (torch.load(tmp_path / d / "final" / "train_state.pt",
                         weights_only=True) for d in ("full", "resumed"))
    assert sa["step"] == sb["step"] == 4
    for k, st in sa["optimizer"]["state"].items():
        for name, v in st.items():
            assert torch.equal(v, sb["optimizer"]["state"][k][name]), name
    # "auto" takes the newest: final before any step
    auto = Trainer(TrainerConfig(iters=1, restore_ckpt="auto",
                                 save_path=str(tmp_path / "full")),
                   device="cpu")
    assert auto.step == 4


# -- restore and the FlyingThings graft --------------------------------------------

def _things_dict(template_vars):
    """A seeded upstream-RAFT-like state dict: JAX-exported, ``module.``
    prefixed, without the ODDC block, with one tensor of another shape,
    BatchNorm counters and a key the model does not have."""
    from prior_flow_tpu.checkpoint.convert import export_state_dict
    sd = export_state_dict(template_vars, add_module_prefix=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("module.ODDC.")}
    sd["module.cnet.conv2.bias"] = np.zeros(10, np.float32)
    sd["module.cnet.norm1.num_batches_tracked"] = np.zeros((), np.int64)
    sd["module.extra.weight"] = np.ones(3, np.float32)
    return sd


def test_things_graft_matches_jax():
    """The port's graft of a seeded "things" dict against JAX's
    ``convert_things_ckpt`` then ``export_state_dict``, every tensor
    bitwise; ``ODDC.gru`` comes from ``update_block.gru``."""
    from prior_flow_tpu.checkpoint.convert import (
        convert_things_ckpt as j_graft, export_state_dict)
    from prior_flow_tpu.models import PriOrRAFT as JaxPriOrRAFT
    from test_torch_port_nn import random_variables
    jm = JaxPriOrRAFT()
    img = jnp.zeros((1, H, W, 3))
    template = random_variables(jm, img, img, iters=1, seed=1)
    things = _things_dict(random_variables(jm, img, img, iters=1, seed=2))
    ref = export_state_dict(j_graft(things, template),
                            add_module_prefix=False)
    got = convert_things_ckpt(
        {k: torch.from_numpy(np.asarray(v)) for k, v in things.items()},
        state_dict_from_jax(template))
    assert set(got) == set(ref)
    for k, v in got.items():
        assert np.array_equal(v.numpy(), np.asarray(ref[k])), k
    src = things["module.update_block.gru.convz1.weight"]
    assert np.array_equal(got["ODDC.gru.convz1.weight"].numpy(), src)


def test_restore_a_reference_pth(tmp_path):
    """A ``module.``-prefixed reference ``.pth`` (with BatchNorm counters)
    loads strictly; a "things" file goes through the graft; an Orbax-like
    directory raises, pointing to the converter's ROADMAP item."""
    sd = build_model("cpu", seed=6).state_dict()
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.cnet.norm1.num_batches_tracked"] = torch.zeros((),
                                                               dtype=torch.long)
    pth = str(tmp_path / "ref.pth")
    torch.save(ref, pth)
    trainer = Trainer(TrainerConfig(iters=1, restore_ckpt=pth), device="cpu")
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert trainer.step == 0

    things = {k: v for k, v in sd.items() if not k.startswith("ODDC.")}
    things["cnet.conv2.weight"] = torch.zeros(10, 128, 1, 1)
    tpth = write_pth(things, str(tmp_path / "things.pth"))
    grafted = Trainer(TrainerConfig(iters=1, seed=2, restore_ckpt=tpth),
                      device="cpu").model.state_dict()
    seeded = build_model("cpu", seed=2).state_dict()
    assert torch.equal(grafted["ODDC.gru.convz1.weight"],
                       sd["update_block.gru.convz1.weight"])
    assert torch.equal(grafted["fnet.conv1.weight"], sd["fnet.conv1.weight"])
    assert torch.equal(grafted["cnet.conv2.weight"],
                       seeded["cnet.conv2.weight"])
    assert torch.equal(grafted["ODDC.encoder.convc1_A.weight"],
                       seeded["ODDC.encoder.convc1_A.weight"])

    orbax = tmp_path / "orbax"
    orbax.mkdir()
    with pytest.raises(ValueError, match="convert_orbax.py"):
        Trainer(TrainerConfig(iters=1, restore_ckpt=str(orbax)), device="cpu")


# -- the flag surface and the logger -----------------------------------------------

def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.nargs, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_and_presets_match_jax(tmp_path, monkeypatch):
    """JAX's flags with their defaults, plus ``--device``; the presets;
    ``--mesh DPxSP`` exits with JAX's message where DP x SP is not the
    number of visible cards (``1x2`` needs 2); without ``--device`` the
    CLI wants the card."""
    ours, ref = _flags(tcli.build_parser()), _flags(jcli.build_parser())
    assert set(ours) - set(ref) == {"device"}
    for k, v in ref.items():
        assert ours[k] == v, k
    assert tcli.PRESETS == jcli.PRESETS
    with pytest.raises(SystemExit, match="chips requested but"):
        tcli.main(["--stage", "EFT", "--mesh", "2x1"])
    with pytest.raises(SystemExit, match="1x2=2 chips requested but"):
        tcli.main(["--stage", "EFT", "--mesh", "1x2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--stage", "EFT", "--save_path", str(tmp_path)])


def test_logger_records_match_jax(tmp_path, monkeypatch, capsys):
    """The same JSONL records but ``ts``, the same stdout line, the same
    sinks; ``--wandb`` without wandb prints and goes on."""
    metrics = {"train/loss": 1.5, "A-epe": 2, "note": "x"}
    for mod, name in ((tlogger, "t"), (jlogger, "j")):
        sink = mod.JsonlSink(str(tmp_path / f"{name}.jsonl"))
        sink.log(metrics, 3)
        sink.close()
        mod.StdoutSink().log(metrics, 3)       # not the 100th: silent
        mod.StdoutSink().log(metrics, 100)
    got, ref = (_jsonl(tmp_path / f"{n}.jsonl")[0] for n in ("t", "j"))
    got.pop("ts"), ref.pop("ts")
    assert got == ref == {"step": 3, "train/loss": 1.5, "A-epe": 2.0}
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1] == "[step 100] train/loss=1.5, A-epe=2"
    monkeypatch.setitem(sys.modules, "wandb", None)
    kw = dict(run_dir=str(tmp_path / "runs"), name="r", use_wandb=True)
    ours = tlogger.MetricLogger.default(**kw)
    theirs = jlogger.MetricLogger.default(**kw)
    assert [type(s).__name__ for s in ours.sinks] == [
        type(s).__name__ for s in theirs.sinks] == ["StdoutSink", "JsonlSink",
                                                    "PngSink"]
    assert "wandb unavailable" in capsys.readouterr().out
    ours.log_images({"a": np.zeros((4, 4, 3), np.uint8)}, 7)
    assert os.listdir(tmp_path / "runs" / "images") == ["00000007_a.png"]
    ours.close(), theirs.close()
