"""Build the port's CUDA kernels at first use and load them through ctypes.

Every ``prior_flow_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process (all started together) for ``sm_90a`` and linked into one shared
library with a plain C interface, under ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``). The library's name carries a hash
of the sources, the shared ``*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is built or imported when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

# --fmad=false: no multiply-add contraction, so the kernels round exactly
# as the plain PyTorch versions do, op for op
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 compiler_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when loaded from the cache
        self.compiler_log = compiler_log


_LOADED: KernelLibrary | None = None


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no kernel sources under {CSRC_DIR}")
    return srcs


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(srcs: list[Path], out: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for src, proc in zip(srcs, procs):
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)
    return "\n".join(logs)


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is None:
        srcs = _sources()
        out = BUILD_DIR / f"libpriorflow_kernels-{_digest(srcs)}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            log = _compile(srcs, out)
        seconds = time.perf_counter() - t0 if log else 0.0
        _LOADED = KernelLibrary(ctypes.CDLL(str(out)), out, seconds, log)
    return _LOADED


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
