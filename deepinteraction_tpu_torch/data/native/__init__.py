"""ctypes binding of the port's native sweep reader (``points_io.cpp``).

``assemble_points`` reads a key cloud and its sweeps, moves each sweep into
the key frame in double precision (``R.x + t``, one cast to float32),
range-filters, optionally shuffles and pads, in one C call: the JAX
package's default sweep path, bit for bit. ``data/pipeline.py::
load_sweep_points`` always goes through it.

The library is compiled with ``g++`` at first use into
``deepinteraction_tpu_torch/build/`` (listed in ``.gitignore``), under a name
that carries a hash of the source and the flags, and published with
``os.replace``, so loader workers that build at once each load a whole
library. A failed build raises with the compiler's output. This module
imports numpy and no torch: the spawned loader workers import it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "points_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build")
# the JAX package's flags, and no contraction into fused multiply-adds
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")
# rows read of each cloud at most; load_sweep_points sizes its buffer by it
MAX_CLOUD_ROWS = 400000

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path(build_dir: str = BUILD_DIR) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"libdi_points_io_{h.hexdigest()[:16]}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile ``points_io.cpp`` unless a build of this source exists in
    ``build_dir``; returns the library's path."""
    lib = library_path(build_dir)
    if os.path.exists(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(path: str) -> ctypes.CDLL:
    """Load a built library and declare ``assemble_points``' signature."""
    lib = ctypes.CDLL(path)
    lib.assemble_points.restype = ctypes.c_int
    lib.assemble_points.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F64, _F64, _F64, ctypes.c_int, _F64, ctypes.c_int,
        ctypes.c_uint64, np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), ctypes.c_int,
    ]
    return lib


def library() -> ctypes.CDLL:
    """This process's library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = load(build())
        return _LIB


def assemble_points(
    paths: Sequence[str],
    rotations: np.ndarray,  # [N, 3, 3] sensor2lidar (identity for the key frame)
    translations: np.ndarray,  # [N, 3]
    ts_deltas: np.ndarray,  # [N] seconds
    pcr: Sequence[float],
    max_points: int,
    load_dim: int = 5,
    shuffle: bool = False,
    seed: int = 0,
    lib: Optional[ctypes.CDLL] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Load, move into the key frame, range-filter, shuffle and pad.

    Returns (points [max_points, load_dim] float32, mask [max_points] bool,
    n_valid). A cloud that cannot be read raises ``OSError``."""
    lib = lib or library()
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.zeros((max_points, load_dim), np.float32)
    mask = np.zeros((max_points,), np.uint8)
    got = lib.assemble_points(
        c_paths, n,
        np.ascontiguousarray(rotations, np.float64).reshape(-1),
        np.ascontiguousarray(translations, np.float64).reshape(-1),
        np.ascontiguousarray(ts_deltas, np.float64),
        load_dim,
        np.ascontiguousarray(pcr, np.float64),
        1 if shuffle else 0, seed, out.reshape(-1), mask, max_points,
    )
    if got < 0:
        raise OSError(f"points_io: cannot read one of {list(paths)}")
    return out, mask.astype(bool), got
