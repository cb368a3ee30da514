"""Build and load the port's hand-written CUDA kernels.

The sources under ``deepinteraction_tpu_torch/csrc/`` are compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, at first use, into ``deepinteraction_tpu_torch/build/`` (listed in
``.gitignore``). The library name carries a hash of the sources, so an edited
kernel is never served from a stale build. It is bound with ``ctypes``: every
pointer and the stream go as ``c_void_p``, and every entry returns the CUDA
error code of its launch, which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("subm_conv.cu", "local_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # feat, nbr, w, valid, out, kin, ko, taps, cin, cout, stream
    "di_subm_conv_gemm": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # q, k, v, out, b, h, w, c, kernel, scale, stream
    "di_local_attn_fwd": ([_P] * 4 + [_I] * 5 + [ctypes.c_float, _P], _I),
    "di_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if no build of these sources exists; returns the
    library path. ``verbose`` adds ``-Xptxas -v`` (registers, spills) and
    prints the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libdi_kernels_{_source_digest()}.so")
    if os.path.exists(lib) and not verbose:
        return lib
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp] + [os.path.join(CSRC_DIR, s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = library().di_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != dev:
            raise RuntimeError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise RuntimeError(f"{name}: expected contiguous tensors")
