"""ctypes binding of the native C++/OpenMP MAS kernel (native/mas.cpp).

Counterpart of `megatts2_hierspeechpp_tpu/ops/mas_native.py`. The library
is compiled from the package's own source with the host's g++ on first
use, into the port's build directory (ops/cuda_lib.BUILD_DIR, ignored by
git) under a name keyed on a hash of the source; no prebuilt binary is
shipped. ops/monotonic_align.py is the torch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from megatts2_hierspeechpp_torch.ops.cuda_lib import BUILD_DIR

SRC = Path(__file__).resolve().parents[1] / "native" / "mas.cpp"


@lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    src_hash = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libmas-{src_hash}.so"
    if not lib_path.exists():
        tmp = f"{lib_path}.tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                        str(SRC), "-o", tmp], check=True)
        os.replace(tmp, lib_path)   # atomic against a concurrent build
    lib = ctypes.CDLL(str(lib_path))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.maximum_path_batch.argtypes = [
        i32p, ctypes.POINTER(ctypes.c_float), i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.maximum_path_batch.restype = None
    return lib


def maximum_path(values: np.ndarray, t_ys: np.ndarray,
                 t_xs: np.ndarray) -> np.ndarray:
    """values: (B, T_y, T_x) float32 -> {0, 1} int32 paths (B, T_y, T_x);
    t_ys / t_xs: (B,) valid lengths within the array's."""
    values = np.array(values, np.float32, order="C")   # the kernel writes it
    b, t_y, t_x = values.shape
    t_ys = np.ascontiguousarray(t_ys, np.int32)
    t_xs = np.ascontiguousarray(t_xs, np.int32)
    if t_ys.shape != (b,) or t_xs.shape != (b,):
        raise ValueError(f"lengths {t_ys.shape} / {t_xs.shape} for B = {b}")
    if ((t_ys < 1) | (t_ys > t_y) | (t_xs < 1) | (t_xs > t_x)
            | (t_xs > t_ys)).any():
        raise ValueError("lengths outside 1 <= t_x <= t_y <= the array's")
    paths = np.zeros((b, t_y, t_x), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _load().maximum_path_batch(
        paths.ctypes.data_as(i32p),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t_ys.ctypes.data_as(i32p), t_xs.ctypes.data_as(i32p), b, t_y, t_x)
    return paths
