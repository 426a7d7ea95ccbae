"""The card a run used, as the result line's ``device`` gives it."""

from __future__ import annotations

import subprocess

import torch


def nvidia_smi(query: str) -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` of the first
    card, or "" where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else ""


def describe(device, count: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(peak_bytes),
            "power_limit": nvidia_smi("power.limit")}
