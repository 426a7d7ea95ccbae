"""Profiling hooks (counterpart of ``prior_flow_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` trace of the block, the host and,
  where a card is present, its kernels, written for TensorBoard under
  ``logdir``.
- ``StepTimer``: step timing in seconds with a warm-up discarded and a
  percentile summary.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str = "runs/torch-trace"):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self):
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "min_s": float(arr.min()),
            "steps": len(arr),
        }
