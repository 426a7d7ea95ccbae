"""Measured rates of the card's own primitives, for the DCCL roofline.

Counterpart of the JAX package's ``tools/microbench_vpu_anchor.py`` at its
sizes, on the port's kernels (``ops/kernels/anchors.py``): GRID = 128 tiles
of (512, 128) f32, chains of K = 256 dependent steps per element, each of

1. select: ``y = where((idx & (1 + (k + j) % 7)) != 0, x, y)``, the select
   that picks a corner's value;
2. gather: ``y = y[row, idx]`` within a 128-wide row, a shared-memory read
   at a data-dependent address. The kernel stores the row and reads it
   back on a read schedule (``anchors.gather_plan``, built once per index
   tensor and timed on its own line) that leaves no bank conflicts: 4
   store and 4 load wavefronts per row-step. So the anchor reads the
   conflict-free floor of such a read, not the cost of the DCCL corner
   fetch, whose addresses come with the data and have no schedule built
   in advance. That fetch's conflicted rate is the old layout's figure in
   the tool's wavefront model, ~15.8 wavefronts per row-step for 4
   consecutive elements per lane read at random indices. The tool prints
   both counts, modelled on the host from idx (``gather_wavefronts``):
   the card offers no counters to read;
3. fma: ``y = fma(y, x, x)``, the bilinear blend's arithmetic;

with 1 and 4 independent chains (ilp) per element: ilp 1 measures the
latency of a dependent chain, ilp 4 comes nearer the primitive's issue
rate. The plan is gated bitwise against its plain version, each anchor
bitwise against its plain version, then each is timed
(the card's time, launches queued ahead); it prints ms and T
element-ops/s with
n_elem = GRID*512*128*K, beside its operations bound: n_elem over the
primitive's results per clock per SM, the SM count and the maximum SM
clock. The SASS of each chain kernel in the built library
(``cuobjdump -sass``) shows the chain's step instructions per element: K,
less at most one per chain (ptxas may fold a chain's first select into its
start, x * c, as a predicated multiply); a folded chain would show a
handful. Then the fixed cost of one block (o = 2x over 512 and 4096
(8, 128) tiles: the slope), each call on inputs and outputs the L2 no
longer holds (``COLD_BYTES``), and of one empty launch.

    python -m prior_flow_tpu_torch.tools.microbench_vpu_anchor
"""

from __future__ import annotations

import collections
import itertools
import os
import re
import subprocess

import torch

from ..models import resolve_device
from ..ops.kernels import _build, launch_counts, reset_launch_counts
from ..ops.kernels.anchors import (ILPS, WARP, anchor_chain,
                                   anchor_chain_plain, gather_plan,
                                   gather_plan_plain, launch_empty,
                                   slot_words, step_cost_copy,
                                   step_cost_copy_plain)
from ._timing import cuda_ms, max_sm_clock_hz, nvidia_smi, queued_ms

TILE_R, LANES = 512, 128
K = 256
GRID = 128
KINDS = ("select", "gather", "fma")
STEP_TILES = (512, 4096)
TILE_ROWS = 8
# the copy's timed calls rotate through this many bytes of inputs and
# outputs, ten times an H100's 50 MB L2, so each call reads and writes HBM
COLD_BYTES = 512 << 20
N_ELEM = GRID * TILE_R * LANES * K
# results per clock per SM on sm_90, from the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table: 32-bit floating-point
# multiply-add 128; a select issues on the pipe of the table's 32-bit
# compare row, 64; a shared-memory read of one 4-byte word per lane, 32
# (128 bytes per clock)
PER_CLOCK_PER_SM = {"fma": 128, "select": 64, "gather": 32}
# the SASS mnemonics that carry one chain step of each kind
SASS_STEP = {"select": ("SEL", "FSEL"), "gather": ("LDS",), "fma": ("FFMA",)}
SASS_SHOWN = ("SEL", "FSEL", "FFMA", "LDS", "SHFL")
ELEMS_PER_THREAD = 4
# a float4 store of a 128-wide row: 512 bytes, 128 a wavefront
ROW_STORE_WAVEFRONTS = LANES * 4 // 128


class GateError(RuntimeError):
    """A kernel disagreed with its plain version."""


def inputs(device, grid: int = GRID, seed: int = 0):
    """x: (grid*512, 128) f32 normals; idx: a permutation of 0..127 per row
    (the gather's source lanes and the select's bits), int32."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(grid * TILE_R, LANES, generator=g, device=device)
    idx = torch.argsort(torch.rand(grid * TILE_R, LANES, generator=g,
                                   device=device), dim=1).to(torch.int32)
    return x, idx


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """Most f32 steps between a and b elementwise; equal infinities and
    NaNs (a chain at |x| > 1 runs to +-inf, and ilp 4 may add +inf to
    -inf) count as 0 apart, a NaN against a number as 2^31."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    # map the sign-magnitude bit patterns onto one ordered integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs()
    na, nb = torch.isnan(a), torch.isnan(b)
    d = torch.where(na & nb, 0, torch.where(na | nb, 2 ** 31, d))
    return int(d.max().item())


def access_wavefronts(words: torch.Tensor) -> torch.Tensor:
    """words: (..., 32) int64 shared-memory word addresses of warp-wide
    4-byte accesses, one per lane. The wavefronts each takes: the most
    distinct words that any one of the 32 banks (word % 32) serves; lanes
    that read one word share it."""
    flat = words.reshape(-1, WARP)
    span = (int(flat.max()) // WARP + 1) * WARP
    present = torch.zeros(flat.shape[0], span, dtype=torch.bool,
                          device=words.device).scatter_(1, flat, True)
    return present.view(flat.shape[0], -1, WARP).sum(1).amax(1).reshape(
        words.shape[:-1])


def gather_wavefronts(idx: torch.Tensor, plan: torch.Tensor):
    """Shared-memory wavefronts per row-step of one gather chain, the mean
    over the rows: (the old layout, the plan). Old: one float4 store of
    the row (4) and 4 loads, load e of lane l at idx[4 l + e] & 127. Plan:
    store k of lane l at word 32 k + l, load k at the plan's source
    word."""
    R = idx.shape[0]
    old_loads = (idx & (LANES - 1)).long().reshape(R, WARP, -1).transpose(1,
                                                                          2)
    old = ROW_STORE_WAVEFRONTS + access_wavefronts(old_loads).sum(1)
    stores = int(access_wavefronts(slot_words().T).sum())
    loads = plan[..., 1].long().transpose(1, 2)
    new = stores + access_wavefronts(loads).sum(1)
    return old.double().mean().item(), new.double().mean().item()


def gate_plan(idx):
    """The plan kernel against its plain version, bitwise; raises
    GateError. Returns (the kernel's plan, the plain version's ms, timed
    once by CUDA events)."""
    got = gather_plan(idx)
    ref = {}
    plain_ms = cuda_ms(lambda: ref.update(out=gather_plan_plain(idx)), 1,
                       warmup=0)
    if not torch.equal(got, ref["out"]):
        bad = int((got != ref["out"]).flatten(1).any(1).sum())
        raise GateError(f"gather plan: {bad} rows differ from the plain "
                        f"version")
    return got, plain_ms


def gate(x, idx, plan=None):
    """Each (kind, ilp) chain on the card against its plain version on the
    same inputs, the gather on ``plan``; raises GateError unless they are
    bitwise equal. Returns {(kind, ilp): (max abs error where both are
    finite, plain ms)}, the plain version timed once by CUDA events."""
    res = {}
    for kind in KINDS:
        for ilp in ILPS:
            got = anchor_chain(x, idx, kind, ilp, K, plan=plan)
            ref = {}
            plain_ms = cuda_ms(lambda: ref.update(
                out=anchor_chain_plain(x, idx, kind, ilp, K)), 1, warmup=0)
            steps = ulps_apart(got, ref["out"])
            if steps:
                raise GateError(f"anchor {kind} ilp={ilp}: {steps} f32 steps "
                                f"from its plain version")
            fin = torch.isfinite(got) & torch.isfinite(ref["out"])
            err = (got - ref["out"])[fin].abs().max().item() if fin.any() \
                else 0.0
            res[kind, ilp] = (err, plain_ms)
    return res


def gate_step_cost(device):
    """The copy kernel against 2x, bitwise, at the larger tile count."""
    xs = torch.randn(STEP_TILES[-1] * TILE_ROWS, LANES, device=device)
    if not torch.equal(step_cost_copy(xs), step_cost_copy_plain(xs)):
        raise GateError("step_cost_copy: not bitwise 2x")


def measure(x, idx, plan, n: int = 20):
    """The card's ms per launch (``queued_ms``) of each (kind, ilp) chain,
    the gather on ``plan``."""
    return {(kind, ilp): queued_ms(lambda: anchor_chain(x, idx, kind, ilp, K,
                                                        plan=plan), n)
            for kind in KINDS for ilp in ILPS}


def cold_ms(fn, device, tiles: int, n: int = 100) -> float:
    """The card's ms per call (``queued_ms``) of ``fn(x)`` on (tiles * 8,
    128) f32 inputs, each call on the next of a rotation of inputs and
    outputs that spans COLD_BYTES, so that none is still in the L2."""
    rows = tiles * TILE_ROWS
    reps = max(2, -(-COLD_BYTES // (2 * rows * LANES * 4)))
    xs = torch.randn(reps * rows, LANES, device=device)
    outs = [None] * reps          # held, so every output lands elsewhere
    calls = itertools.count()

    def call():
        j = next(calls) % reps
        outs[j] = fn(xs[j * rows:(j + 1) * rows])
    return queued_ms(call, n)


def measure_step_cost(device, n: int = 100) -> dict:
    """The copy at each of STEP_TILES tiles (``cold_ms``): ms, the plain
    version's ms at the larger count, the slope per extra block in us; and
    one empty launch in us, queued (the card's cost) and issued back to
    back (the host's cost of issuing a launch through a wrapper)."""
    ms = {t: cold_ms(step_cost_copy, device, t, n) for t in STEP_TILES}
    t0, t1 = STEP_TILES
    return dict(ms=ms, plain_ms=cold_ms(step_cost_copy_plain, device, t1, n),
                slope_us=(ms[t1] - ms[t0]) * 1e3 / (t1 - t0),
                empty_us=queued_ms(lambda: launch_empty(device), n) * 1e3,
                empty_paced_us=cuda_ms(lambda: launch_empty(device), n) * 1e3)


def _cuobjdump() -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def parse_sass(text: str):
    """{(kind, ilp): Counter of SASS mnemonics} of each chain kernel in
    ``cuobjdump -sass`` output."""
    counts, cur = {}, None
    kinds = dict(enumerate(KINDS))
    fn_re = re.compile(r"Function : (\S+)")
    kern_re = re.compile(r"anchor_chain_kernelILi(\d+)ELi(\d+)E")
    ins_re = re.compile(
        r"^\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    for line in text.splitlines():
        m = fn_re.search(line)
        if m:
            k = kern_re.search(m.group(1))
            cur = (kinds[int(k.group(1))], int(k.group(2))) if k else None
            if cur:
                counts[cur] = collections.Counter()
        elif cur:
            m = ins_re.match(line)
            if m:
                counts[cur][m.group(1)] += 1
    return counts


def sass_counts():
    """``parse_sass`` of the built library."""
    lib = _build.load_library().path
    out = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    return parse_sass(out.stdout)


def steps_per_element(counts, kind: str, ilp: int) -> float:
    """The chain-step instructions of (kind, ilp) per element."""
    c = counts[kind, ilp]
    return sum(c[op] for op in SASS_STEP[kind]) / ELEMS_PER_THREAD


def chain_intact(counts, kind: str, ilp: int) -> bool:
    """K step instructions per element, less at most one per chain: ptxas
    may fold a chain's first select into the chain's start."""
    return steps_per_element(counts, kind, ilp) >= K - ilp


def ops_bound_ms(kind: str, n_elem: int, sms: int, clock_hz: float) -> float:
    return n_elem / (PER_CLOCK_PER_SM[kind] * sms * clock_hz) * 1e3


def run(device):
    """The tool's procedure at its size: the gather's plan built once and
    gated, every chain and the copy gated against their plain versions,
    the SASS checked for folded chains (GateError on any), then measured,
    the plan's build on its own. Returns (chains, step, plan, launches):
    chains {(kind, ilp): dict(ms, plain_ms, err, steps_per_elem, sass)},
    step as ``measure_step_cost``, plan dict(ms, plain_ms, rows,
    wavefronts_old, wavefronts_plan), launches the measurement's launch
    counts."""
    x, idx = inputs(device)
    plan, plan_plain_ms = gate_plan(idx)
    gated = gate(x, idx, plan)
    gate_step_cost(device)
    counts = sass_counts()
    for kind in KINDS:
        for ilp in ILPS:
            if not chain_intact(counts, kind, ilp):
                raise GateError(
                    f"anchor {kind} ilp={ilp}: "
                    f"{steps_per_element(counts, kind, ilp)} step "
                    f"instructions per element in the SASS, fewer than "
                    f"K - ilp = {K - ilp}: the chain was folded")
    old, new = gather_wavefronts(idx, plan)
    reset_launch_counts()
    ms = measure(x, idx, plan)
    plan_rec = dict(ms=queued_ms(lambda: gather_plan(idx), 20),
                    plain_ms=plan_plain_ms, rows=idx.shape[0],
                    wavefronts_old=old, wavefronts_plan=new)
    step = measure_step_cost(device)
    launches = launch_counts()
    chains = {key: dict(ms=t, err=gated[key][0], plain_ms=gated[key][1],
                        steps_per_elem=steps_per_element(counts, *key),
                        sass={op: counts[key][op] for op in SASS_SHOWN})
              for key, t in ms.items()}
    return chains, step, plan_rec, launches


def chain_line(kind: str, ilp: int, c: dict, sms: int, clock_hz: float):
    """One chain's result as the tool prints it."""
    sass = ", ".join(f"{op} {v}" for op, v in c["sass"].items())
    return (f"{kind:>8} ilp={ilp}: {c['ms']:8.4f} ms for {K} ops x "
            f"{GRID}x({TILE_R},{LANES}) f32 -> {N_ELEM / c['ms'] / 1e9:7.3f} "
            f"T elem-ops/s; bound "
            f"{ops_bound_ms(kind, N_ELEM, sms, clock_hz):.4f} ms (operations); "
            f"bitwise its plain version ({c['plain_ms']:.1f} ms); SASS: "
            f"{c['steps_per_elem']} step instructions per element; per "
            f"thread of 4 elements {sass}")


def plan_line(plan: dict) -> str:
    """The gather plan's result as the tool prints it."""
    return (f"gather plan: {plan['ms']:8.4f} ms for {plan['rows']} rows "
            f"(one launch, outside the chains' timing), bitwise its plain "
            f"version ({plan['plain_ms']:.1f} ms); shared-memory wavefronts "
            f"per row-step, modelled from idx: old layout "
            f"{plan['wavefronts_old']:.3f}, plan {plan['wavefronts_plan']:.3f}"
            f" (the bound counts {LANES // WARP} loads)")


def step_line(step: dict) -> str:
    """The block step's result as the tool prints it."""
    t0, t1 = STEP_TILES
    return (f"block step: {step['slope_us']:8.4f} us per (8, 128) block "
            f"(slope {t0}->{t1} blocks from HBM; {step['ms'][t0]:.4f} -> "
            f"{step['ms'][t1]:.4f} ms, plain {step['plain_ms']:.4f}); empty "
            f"launch {step['empty_us']:.3f} us queued, "
            f"{step['empty_paced_us']:.3f} us issued back to back")


def main() -> None:
    dev = resolve_device()
    print(f"{nvidia_smi('name,power.limit')}; "
          f"clocks.max.sm {nvidia_smi('clocks.max.sm')}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_hz()
    chains, step, plan, _ = run(dev)
    for (kind, ilp), c in chains.items():
        print(chain_line(kind, ilp, c, sms, clock), flush=True)
    print(plan_line(plan), flush=True)
    print(step_line(step), flush=True)


if __name__ == "__main__":
    main()
