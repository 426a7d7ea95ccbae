"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiler trace of the window's first batches or
steps. Either way the run checks what its window produced against the
frozen reference (``correct``) and prints each compared number beside its
limit, last on standard error and last in the result line (``checked``).
The run needs as many CUDA cards as the cell asks for, and fails without
them, as it does if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run, at fixed paths inside the checkout
CACHE = ROOT / "build" / "bench_cache"
BANNED = ("jax", "jaxlib", "flax", "prior_flow_tpu")


def set_cache_dirs():
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``prior_flow_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def strict_json(x):
    """``x`` with every NaN or infinity replaced by None, so the line is
    strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: strict_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [strict_json(v) for v in x]
    return x


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float = T0) -> dict:
    """The result of one run of ``cell`` on ``device`` (no check of the card)."""
    import torch
    from . import cells, check, device as devinfo, spec, weights
    fam = spec.family(cell.config)
    t_imports = time.perf_counter()
    sd = weights.seeded_state_dict(fam.param_spec(cell.config), seed, device)
    cells.sync(device)
    t_weights = time.perf_counter()
    o = cells.DRIVERS[cell.traffic["mode"]](cell, fam, sd, seed, seconds, trace, device, t0)
    o.diag["setup_stages_s"] = {"imports": t_imports - t0, "weights": t_weights - t_imports,
                                **o.stages}
    correct, rows = check.judge(o.numbers, cell.limits)
    correct = correct and o.failed == 0
    if trace:
        ctx = {"cell": cell, "family": fam, "summary": o.summary, "units": o.units}
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(ctx) if o.summary is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {**o.values, "setup_s": o.setup_s, "peak_gb": o.peak_bytes / 1e9}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = devinfo.describe(device, cell.chips, o.peak_bytes)
    if trace and o.summary is not None:
        dev["busy_s"], dev["window_s"] = o.summary["busy_s"], o.summary["window_s"]
    result = {"correct": bool(correct), "attempted": o.attempted, "failed": o.failed,
              "metrics": metrics, "device": dev, "diag": o.diag}
    if trace and o.summary is not None:
        result["breakdown"] = {"device_ops": [[n, t] for n, t in o.summary["top_ops"]],
                               "idle_gaps": [[n, t] for n, t in o.summary["idle_gaps"]]}
    result["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name} = {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct = {bool(correct)} (failed {o.failed} of {o.attempted})", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    from . import spec
    cell = spec.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(strict_json(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
