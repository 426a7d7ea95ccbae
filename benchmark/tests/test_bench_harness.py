"""The harness on the CPU: ``BENCHMARK.json`` against the contract and its
files, a tiny run's result line, the counts against hand sums, the trace
reduction on made-up events, and the import rules."""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, check, flops, readers, run, spec, trace
from benchmark.families import priorraft as fam_priorraft
from benchmark.families import raft as fam_raft

ROOT = spec.ROOT
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TINY = dict(height=64, width=128, batch=2, pool_pairs=4, warmup_batches=1, check_among=2,
            check_batches=1, trace_batches=1, ref_rows=2)


def tiny_cell(name: str, iters: int = 2):
    """A cell of ``BENCHMARK.json`` at 64x128, its limits as committed."""
    cell = spec.Cell(name)
    full = cell.traffic
    cell.traffic = {**full, **TINY}
    # as committed: every pair of the checked batch, or a share of them
    cell.traffic["check_pairs"] = full["check_pairs"] * TINY["batch"] // full["batch"]
    cell.config = {**cell.config, "iters": iters}
    return cell


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(BENCH["end_to_end"]) <= 5 and any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(workload):
    cell = spec.Cell(workload, BENCH)
    assert cell.chips == 1
    fam = spec.family(cell.config)
    assert fam.__name__.endswith(cell.config["family"])
    assert cell.traffic["mode"] in cells.DRIVERS
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and "peak_gb" in e2e and len(e2e) >= 3
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))


def test_every_metric_has_a_reader_and_a_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "benchmark" / "metrics" / (m["name"] + ".py")).is_file()
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []


def _result_line(result: dict) -> dict:
    line = json.dumps(result)
    parsed = json.loads(line.splitlines()[-1])
    assert list(parsed)[-1] == "checked"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in parsed
    return parsed


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_tiny_run_prints_a_result_line(workload):
    torch.manual_seed(0)
    cell = tiny_cell(workload)
    res = _result_line(run.run_cell(cell, 2 ** 31 + 77, 0.2, False, torch.device("cpu")))
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) >= {"setup_s", "peak_gb"}
    for m in res["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    assert res["attempted"] >= cell.traffic["batch"] and res["failed"] == 0
    assert set(res["checked"]) == set(cell.limits)
    assert set(res["diag"]["setup_stages_s"]) >= {"imports", "weights", "build", "frames"}


def test_cli_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch, sys\nfrom benchmark import run, spec\n"
            "cell = spec.Cell('raft-infer-512x1024-b16-bf16')\n"
            "print(run.run_cell(cell, 1, 0.1, False, torch.device('cpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "prior_flow_tpu_torch_fake", sys)
    assert "prior_flow_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "prior_flow_tpu.ops", sys)
    assert run.banned_modules() == ["prior_flow_tpu"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(run.BANNED), path
        if "reference" in path.parts:
            assert "prior_flow_tpu_torch" not in tops, path


def test_reference_loads_none_of_the_program():
    code = ("import sys\nimport benchmark.reference.priorraft, benchmark.reference.raft\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('prior_flow_tpu_torch', 'prior_flow_tpu', 'jax')]\nprint(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


CFG = {"hidden_dim": 128, "context_dim": 128, "fnet_dim": 256, "corr_levels": 4,
       "corr_radius": 4, "iters": 2}


def _encoder_flops(H, W, out_dim):
    px = lambda s: (H // s) * (W // s)
    f = 2 * 3 * 64 * 49 * px(2)                                   # stem
    f += 4 * 2 * 64 * 64 * 9 * px(2)                              # layer1
    f += 2 * 64 * 96 * 9 * px(4) + 3 * 2 * 96 * 96 * 9 * px(4) + 2 * 64 * 96 * px(4)
    f += 2 * 96 * 128 * 9 * px(8) + 3 * 2 * 128 * 128 * 9 * px(8) + 2 * 96 * 128 * px(8)
    return f + 2 * 128 * out_dim * px(8)


def _heads_flops(px, mask):
    f = 6 * 2 * 384 * 128 * 5 * px + 2 * 128 * 256 * 9 * px + 2 * 256 * 2 * 9 * px
    return f + (2 * 128 * 256 * 9 * px + 2 * 256 * 576 * px if mask else 0)


def test_flops_against_hand_sums():
    H, W, it = 64, 128, 2
    px = (H // 8) * (W // 8)
    corr = 2 * px * px * 256
    basic = px * 2 * (324 * 256 + 256 * 192 * 9 + 2 * 128 * 49 + 128 * 64 * 9 + 256 * 126 * 9)
    multi = px * 2 * (324 * 256 + 256 * 128 * 9 + 2 * (2 * 128 * 49 + 128 * 64 * 9)
                      + 8 * 32 * 9 + 32 * 16 * 9 + 272 * 124 * 9)
    enc = _encoder_flops(H, W, 256)
    raft_test = 3 * enc + corr + it * (basic + _heads_flops(px, False)) + (
        _heads_flops(px, True) - _heads_flops(px, False))
    assert flops.forward_flops(fam_raft, CFG, H, W, it) == pytest.approx(raft_test, rel=1e-12)
    prior_test = 6 * enc + 2 * corr + it * (basic + multi + 2 * _heads_flops(px, False)) + (
        _heads_flops(px, True) - _heads_flops(px, False))
    assert flops.forward_flops(fam_priorraft, CFG, H, W, it) == pytest.approx(prior_test,
                                                                            rel=1e-12)


def test_bytes_against_hand_sums():
    H, W, B = 64, 128, 2
    q, k = (H // 8) * (W // 8), 81
    bq = B * q
    elems = flops.dccl_window_elements(H, W, 4, 4, "cpu")
    # level 0 at integer centres: each own window is the 9x9 taps cut to rows 0..7
    rows = sum(min(y + 4, 7) - max(y - 4, 0) + 1 for y in range(8))
    assert elems[0][0] == 2 * 16 * 9 * rows
    got = flops.lookup_bytes(H, W, B, 4, 4, 2, "cpu")
    fixed = 4 * (4 * bq * k * 4 + 2 * bq * 8 + 2 * q * 2 * 4)
    assert got == fixed + B * 2 * sum(o + c for o, c in elems)


def _event(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def test_trace_reduction_on_made_up_events():
    events = [_event(trace.WINDOW, "user_annotation", 1000, 1000),
              _event("outer_op", "cpu_op", 1000, 1000),
              _event("aten::copy_", "cpu_op", 1150, 200),
              _event("cudnn_convolution_fwd", "kernel", 1000, 100),
              _event("dccl_level_kernel<float>", "kernel", 1050, 100),
              _event("elementwise_kernel", "kernel", 1500, 100),
              _event("Memcpy HtoD", "gpu_memcpy", 1700, 100),
              _event("outside", "kernel", 2500, 100)]
    s = trace.reduce(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["launches"] == 3
    assert s["conv_s"] == pytest.approx(100e-6) and s["port_s"] == pytest.approx(100e-6)
    assert s["copy_s"] == pytest.approx(100e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(350e-6)
    assert gaps["outer_op"] == pytest.approx(300e-6)
    ctx = {"cell": spec.Cell(BENCH["workloads"][0]["name"]), "family": fam_priorraft,
           "summary": s, "units": 2}
    assert readers.idle_share(ctx) == pytest.approx(65.0)
    assert readers.launches(ctx) == 1.5
    assert readers.plain_ms(ctx) == pytest.approx(0.05)
    assert readers.conv_ms(ctx) == pytest.approx(0.05)
    # a reader with nothing to read returns nothing
    no_lookup = trace.reduce([e for e in events if not e["name"].startswith("dccl")])
    assert readers.lookup_roofline({**ctx, "summary": no_lookup}) is None


def test_judge_needs_every_limit_met():
    assert check.judge({"a": 0.1}, {"a": 0.2})[0]
    assert not check.judge({"a": 0.3}, {"a": 0.2})[0]
    assert not check.judge({}, {"a": 0.2})[0]
    assert not check.judge({"a": math.nan}, {"a": 0.2})[0]
    assert not check.judge({"a": 0.1}, {})[0]
