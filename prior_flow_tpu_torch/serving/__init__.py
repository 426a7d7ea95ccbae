"""Serving subsystem: AOTInductor compilation and portable ``torch.export``
programs of the inference forward (capability beyond the reference, which
has no serving layer; counterpart of ``prior_flow_tpu/serving``).

Deployment guidance from the JAX package (docs/ARCHITECTURE.md §7): run
batch 1 per device and scale streams across devices, since batching within
a device raises the per-pair cost (the 4x correlation-volume working set
outweighs the convolutions' amortisation); latency-sensitive video serving
can opt into fewer GRU iterations with warm-start chaining
(``cli/video.py --warm_start --iters N``); the 12-iteration parity
protocol stays the default. The port's own figures are in PERF.md."""

from .export import (aot_compile, export_forward, exported_summary,
                     load_exported, make_forward, save_exported)

__all__ = [
    "aot_compile",
    "export_forward",
    "exported_summary",
    "load_exported",
    "make_forward",
    "save_exported",
]
