"""Timing on the card and the card's own facts, shared by the port's tools
and ``chip_smoke.py``.

Times are CUDA-event times of ``n`` calls after a warm-up, on the current
stream, in one of two ways:

- ``cuda_ms``: the calls issued back to back, as a program issues them. A
  call whose kernel takes less time than the host takes to issue it (the
  Python wrapper, ctypes, the output allocations) is paced by the host.
- ``queued_ms``: the same calls queued behind a spin kernel
  (``torch.cuda._sleep``) long enough for the host to issue all of them,
  so the events time the card's work alone: a kernel's own time.

Nothing is subtracted: the calls run on the card that the process holds,
with no dispatch link in between.
"""

from __future__ import annotations

import subprocess
import time

import torch

# clock cycles per second that a spin is sized by: at or above an H100's
# SM clock, so a spin lasts at least as long as it was sized for
SPIN_HZ = 2.0e9


def cuda_ms(fn, n: int, warmup: int = 5) -> float:
    """Mean ms per call of ``fn()`` over ``n`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def queued_ms(fn, n: int, warmup: int = 5) -> float:
    """Mean ms of the card's work per call of ``fn()`` over ``n`` calls that
    wait behind a spin kernel until all of them are queued. ``fn`` must
    launch few kernels (the card's queue holds about a thousand). Raises if
    four spins, each four times longer, ended before the host had issued
    the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin_s = 2 * n * (time.perf_counter() - t0) / 3 + 1e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(spin_s * SPIN_HZ))
        start.record()
        for _ in range(n):
            fn()
        queued = not start.query()   # the card still spinning: all queued
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / n
        spin_s *= 4
    raise RuntimeError("queued_ms: the host could not queue the calls "
                       "before the spin ended")


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of the first
    card, e.g. ``"name,power.limit"``; raises if nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (``clocks.max.sm``) in Hz."""
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
