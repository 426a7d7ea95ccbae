"""The frozen reference against the program at 64x128, 2 iterations, on
the CPU; the check failing under planted faults; and, on a card, the
lower-precision control failing the cells' limits while the program
meets them."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, check, run, spec, weights
from benchmark.reference import priorraft as ref_prior
from benchmark.reference import raft as ref_raft
from benchmark.tests.test_bench_harness import CFG, tiny_cell

P1 = "priorraft-infer-512x1024-b16-bf16"
RAFT = "raft-infer-512x1024-b16-bf16"


def _pairs(n=2, H=64, W=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, H, W, 3, generator=g) * 255, torch.rand(n, H, W, 3, generator=g) * 255)


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("family,ref", [("priorraft", ref_prior), ("raft", ref_raft)])
def test_reference_matches_the_program(family, ref):
    from prior_flow_tpu_torch.models import build_model, build_raft
    sd = weights.seeded_state_dict(ref.param_spec(CFG), 11, "cpu")
    build = build_model if family == "priorraft" else build_raft
    model = build("cpu", state_dict=sd)
    i1, i2 = _pairs()
    with torch.no_grad():
        assert _rel(model(i1, i2, iters=2), ref.forward(sd, CFG, i1, i2, 2)) < 1e-5


def test_state_dict_spec_is_the_programs():
    from prior_flow_tpu_torch.models import PriOrRAFT, RAFT
    for model, ref in ((PriOrRAFT(), ref_prior), (RAFT(), ref_raft)):
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == {k: tuple(s) for k, s in ref.param_spec(CFG)}


# -- the check under planted faults -------------------------------------------

class _Broken(torch.nn.Module):
    """The program's model with one fault planted in its forward."""

    def __init__(self, model, fault):
        super().__init__()
        self.model, self.fault = model, fault

    def forward(self, image1, image2, **kw):
        flow = self.model(image1, image2, **kw)
        if self.fault == "unchanged":        # the iterations never move the flow
            return torch.zeros_like(flow)
        half = flow.shape[0] // 2
        if self.fault == "half_batch":       # half left out, the rest's mean in its place
            return torch.cat([flow[:half], flow[:half].mean(0, keepdim=True).expand(
                flow.shape[0] - half, -1, -1, -1)])
        flow = flow.clone()
        if self.fault == "altered":          # one answer reversed where it is made
            flow[-1] = -flow[-1]
        else:                                # one answer wrong at the wrap seam alone:
            seam = flow.shape[2] // 16       # a sixteenth of its columns at each edge
            flow[-1, :, :seam] += 4.0
            flow[-1, :, -seam:] += 4.0
        return flow


@pytest.mark.parametrize("workload", [P1, RAFT])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "seam"])
def test_inference_faults_are_caught(monkeypatch, workload, fault):
    """Under the cell's committed limits and share of checked pairs."""
    cell = tiny_cell(workload)
    fam = spec.family(cell.config)
    build = fam.build
    monkeypatch.setattr(fam, "build", lambda *a, **k: _Broken(build(*a, **k), fault))
    res = run.run_cell(cell, 2 ** 32 + 5, 0.1, False, torch.device("cpu"))
    assert res["correct"] is False, res["checked"]


# -- the control on a card ------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("workload,control", [(P1, "fp8"), (RAFT, "fp8")])
def test_control_fails_the_limits_on_a_card(workload, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cell = spec.Cell(workload)
    small = dict(height=128, width=256, batch=2, pool_pairs=4, warmup_batches=1,
                 check_among=2, check_batches=1, check_pairs=2)
    cell.traffic = {**cell.traffic, **small}
    numbers = calibrate.control_numbers(cell, 3, control, dev)
    ok, _ = check.judge(numbers, cell.limits)
    assert not ok, numbers
