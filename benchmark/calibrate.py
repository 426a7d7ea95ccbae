"""Readings that the correctness limits are set from, for one cell:

    python -m benchmark.calibrate --workload <name> --seeds 1 2 3 ... \
        [--control fp8 --control-seeds 1 2 3] [--seconds 2]

For each of ``--seeds`` a run of the cell (a short window, then the check
as ``run`` makes it) gives the program's numbers: the lower reading is
their largest. For each of ``--control-seeds`` the frozen reference
computed in the lower precision ``--control`` is put in the program's
place on the same inputs and the same checked pairs: the upper reading
is the smallest of its numbers. One JSON line per reading on standard
output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, check, run, spec, traffic, weights


def control_numbers(cell, seed: int, arith: str, device) -> dict:
    fam = spec.family(cell.config)
    cfg, tr = cell.config, cell.traffic
    sd = weights.seeded_state_dict(fam.param_spec(cfg), seed, device)
    rows = cells.ref_rows(tr, device)
    B = tr["batch"]
    im1, im2 = traffic.make_pairs(tr["pool_pairs"], tr["height"], tr["width"],
                                        traffic.flow_rms(tr), seed, traffic.FRAMES, device)
    nb = tr["pool_pairs"] // B
    refs, lows = [], []
    for i, pick in cells._picks(seed, tr).items():
        a, b = cells.checked_pairs(im1, im2, i, pick, nb, B, device)
        refs.append(cells.reference_flows(fam, cfg, sd, a, b, rows, "fp32"))
        lows.append(cells.reference_flows(fam, cfg, sd, a, b, rows, arith))
    return check.flow_numbers(torch.cat(lows), torch.cat(refs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("fp8",))
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    cell = spec.Cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, dev, t)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "program",
                          "numbers": {k: v["value"] for k, v in res["checked"].items()},
                          "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "diag": res["diag"], "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t = time.perf_counter()
        nums = control_numbers(cell, seed, args.control, dev)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": "control:" + args.control,
                          "numbers": nums, "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
