"""ctypes binding to the repo's native host library
(``native/priorflow_io.cc``; counterpart of
``prior_flow_tpu/data/native.py``): .flo decoding with a fused u-wrap,
the horizontal roll, and the eraser's rectangle paint and mean colour.
Every function has the JAX module's numpy fallback, taken when no library
is loaded; ``available()`` says which path is active. This is host-side
data code, not the device path.

The library is looked up at ``native/libpriorflow_io.so`` (what
``make -C native`` builds), or loaded from a given path with ``load``.
``build`` compiles the source into a directory of its own (default
``build/native/`` under the repo) and never writes under ``native/``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO_ROOT, "native", "priorflow_io.cc")
_LIB_NAME = "libpriorflow_io.so"
DEFAULT_LIB = os.path.join(_REPO_ROOT, "native", _LIB_NAME)
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")

_lib = None


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    c_int, c_char_p = ctypes.c_int, ctypes.c_char_p
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pf_flo_dims.argtypes = [c_char_p, ctypes.POINTER(c_int),
                                ctypes.POINTER(c_int)]
    lib.pf_flo_dims.restype = c_int
    lib.pf_read_flo.argtypes = [c_char_p, f32p, c_int, c_int, c_int]
    lib.pf_read_flo.restype = c_int
    lib.pf_roll.argtypes = [c_char_p, c_char_p, c_int, c_int, c_int, c_int,
                            c_int]
    lib.pf_roll.restype = None
    lib.pf_erase_rect.argtypes = [c_char_p, c_int, c_int, c_int, c_int,
                                  c_int, c_int, f32p]
    lib.pf_erase_rect.restype = None
    lib.pf_mean_color.argtypes = [c_char_p, c_int, c_int, f32p]
    lib.pf_mean_color.restype = None
    return lib


def load(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    """The bound library: the one loaded before, else the one at ``path``
    (default ``native/libpriorflow_io.so``), or None where that file does
    not exist."""
    global _lib
    if _lib is not None:
        return _lib
    path = path or DEFAULT_LIB
    if not os.path.exists(path):
        return None
    _lib = _bind(path)
    return _lib


def build(out_dir: str = BUILD_DIR) -> str:
    """Compile ``native/priorflow_io.cc`` with the flags of
    ``native/Makefile`` into ``out_dir`` and return the library's path.
    Raises ``RuntimeError`` when no C++ compiler is found or it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, _LIB_NAME)
    cmd = [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-o", out,
           _SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr}")
    return out


def available() -> bool:
    return load() is not None


def read_flo(path: str, wrap_u: bool = False) -> np.ndarray:
    """.flo reader with an optional fused u-wrap into [-W/2, W/2); numpy
    fallback."""
    lib = load()
    if lib is None:
        from . import frame_utils
        flow = frame_utils.read_flo(path)
        if wrap_u:
            W = flow.shape[1]
            flow[:, :, 0] = (flow[:, :, 0] + W / 2) % W - W / 2
        return flow
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.pf_flo_dims(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"{path}: bad .flo file (rc={rc})")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.pf_read_flo(path.encode(),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         h.value, w.value, int(wrap_u))
    if rc != 0:
        raise ValueError(f"{path}: truncated .flo file (rc={rc})")
    return out


def roll(arr: np.ndarray, shift: int) -> np.ndarray:
    """``np.roll(arr, shift, axis=1)`` for HWC arrays."""
    lib = load()
    if lib is None:
        return np.roll(arr, shift, axis=1)
    arr = np.ascontiguousarray(arr)
    out = np.empty_like(arr)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    lib.pf_roll(arr.ctypes.data_as(ctypes.c_char_p),
                out.ctypes.data_as(ctypes.c_char_p),
                h, w, c, int(shift), arr.itemsize)
    return out


def erase_rect(img: np.ndarray, x0: int, y0: int, dx: int, dy: int,
               color: np.ndarray) -> None:
    """In-place mean-colour rectangle paint (uint8 RGB)."""
    lib = load()
    if lib is None or img.dtype != np.uint8 or img.shape[-1] != 3 \
            or not img.flags.c_contiguous:
        img[y0:y0 + dy, x0:x0 + dx, :] = color
        return
    c = np.ascontiguousarray(color, np.float32)
    lib.pf_erase_rect(img.ctypes.data_as(ctypes.c_char_p),
                      img.shape[0], img.shape[1], x0, y0, dx, dy,
                      c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))


def mean_color(img: np.ndarray) -> np.ndarray:
    """The mean RGB colour of an (H, W, 3) image."""
    lib = load()
    if lib is None or img.dtype != np.uint8 or img.shape[-1] != 3 \
            or not img.flags.c_contiguous:
        return np.mean(img.reshape(-1, 3), axis=0)
    out = np.empty(3, np.float32)
    lib.pf_mean_color(img.ctypes.data_as(ctypes.c_char_p),
                      img.shape[0], img.shape[1],
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
