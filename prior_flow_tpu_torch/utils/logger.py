"""Metric logging (counterpart of ``prior_flow_tpu/utils/logger.py``):
``MetricLogger`` fans each record out to its sinks, stdout, JSONL and
PNG panels always, wandb when asked for and importable, so training runs
alike with or without a wandb install. The JSONL records are the JAX
package's: ``step``, ``ts`` and every numeric metric.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class PngSink:
    """Writes image panels as PNGs under run_dir/images (the local
    counterpart of wandb's image panels)."""

    def __init__(self, run_dir: str):
        self.dir = os.path.join(run_dir, "images")

    def log(self, metrics: Dict, step: int):
        pass

    def log_images(self, images: Dict, step: int):
        import numpy as np
        try:
            import cv2
        except ImportError:
            return
        os.makedirs(self.dir, exist_ok=True)
        for name, img in images.items():
            arr = np.asarray(img)
            if arr.dtype != "uint8":
                arr = arr.clip(0, 255).astype("uint8")
            cv2.imwrite(os.path.join(self.dir, f"{step:08d}_{name}.png"),
                        arr[..., ::-1] if arr.ndim == 3 else arr)

    def close(self):
        pass


class JsonlSink:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, metrics: Dict, step: int):
        rec = {"step": step, "ts": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float))})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()


class StdoutSink:
    def __init__(self, every: int = 100):
        self.every = every
        self._last = -1

    def log(self, metrics: Dict, step: int):
        if step - self._last >= self.every:
            self._last = step
            items = ", ".join(f"{k}={float(v):.4g}" for k, v in metrics.items()
                              if isinstance(v, (int, float)))
            print(f"[step {step}] {items}", flush=True)

    def close(self):
        pass


class WandbSink:
    """Optional wandb sink; construction fails gracefully without wandb."""

    def __init__(self, project: str, name: str, config=None):
        import wandb  # raises ImportError if unavailable

        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, config=config)

    def log(self, metrics: Dict, step: int):
        self._wandb.log(metrics, step)

    def log_images(self, images: Dict, step: int):
        self._wandb.log({k: self._wandb.Image(v) for k, v in images.items()},
                        step)

    def close(self):
        self._wandb.finish()


class MetricLogger:
    def __init__(self, *sinks):
        self.sinks = list(sinks)

    @classmethod
    def default(cls, run_dir: str = "runs", name: str = "run",
                project: Optional[str] = None, config=None,
                use_wandb: bool = False):
        sinks = [StdoutSink(), JsonlSink(os.path.join(run_dir, name + ".jsonl")),
                 PngSink(run_dir)]
        if use_wandb:
            try:
                sinks.append(WandbSink(project or "prior-flow-tpu", name, config))
            except Exception as e:  # no wandb / not logged in
                print(f"wandb unavailable ({e}); continuing with local sinks")
        return cls(*sinks)

    def __call__(self, metrics: Dict, step: int):
        for s in self.sinks:
            s.log(metrics, step)

    def log_images(self, images: Dict, step: int):
        for s in self.sinks:
            if hasattr(s, "log_images"):
                s.log_images(images, step)

    def close(self):
        for s in self.sinks:
            s.close()
