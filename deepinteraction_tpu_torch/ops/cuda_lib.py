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
SOURCES = (
    "subm_conv.cu", "subm_conv_bf16.cu", "local_attention.cu", "local_attention_bf16.cu", "auction_lap.cu",
    "sparse_tables.cu",
)
HEADERS = ("tf32_mma.cuh", "bf16_mma.cuh")  # included by the sources: part of the build's hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # feat, nbr, w, valid, out, kin, ko, taps, cin, cout, stream
    "di_subm_conv_gemm": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # the same, then gate, taken, stream
    "di_subm_conv_gemm_gated": ([_P] * 5 + [_I] * 5 + [_P] * 3, _I),
    # feat, nbr, wt, valid, out, kin, ko, taps, cin, cout, per_tap, gate, taken, stream
    "di_subm_conv_bf16": ([_P] * 5 + [_I] * 6 + [_P] * 3, _I),
    # feat, nbr, dy, partial, out, kin, ko, taps, cin, cout, chunks, stream
    "di_subm_conv_wgrad": ([_P] * 5 + [_I] * 6 + [_P], _I),
    # q, k, v, out, b, h, w, c, kernel, scale, stream
    "di_local_attn_fwd": ([_P] * 4 + [_I] * 5 + [ctypes.c_float, _P], _I),
    "di_local_attn_fwd_bf16": ([_P] * 4 + [_I] * 5 + [ctypes.c_float, _P], _I),
    # kernel, out[5]
    "di_local_attn_fwd_bf16_info": ([_I, ctypes.POINTER(_I)], _I),
    # q, k, v, dout, dq, dk, dv, lse, dsum, b, h, w, c, kernel, scale, stream
    "di_local_attn_bwd": ([_P] * 9 + [_I] * 5 + [ctypes.c_float, _P], _I),
    # cost, num_gt, eps_rel (host floats), out, rounds, n, p, g, phases, cap, stream
    "di_auction_lap": ([_P, _P, ctypes.POINTER(ctypes.c_float), _P, _P] + [_I] * 5 + [_P], _I),
    # p, g -> 1 where the benefits are staged in shared memory, 0 where read from L2
    "di_auction_lap_staged": ([_I, _I], _I),
    # the sparse encoder's tables (ops/sparse_conv.py); geom: int[12], the
    # kernel, stride, padding and grid, z y x each
    # coords, valid, dense, k, nz, ny, nx, stream
    "di_dense_index_map": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # dense, out_coords, out_valid, table, ko, miss, geom, stream
    "di_neighbor_table": ([_P] * 4 + [_I] * 2 + [ctypes.POINTER(_I), _P], _I),
    # nbr, valid, flag, k, t, w, start_hi, stream
    "di_banded_overflow": ([_P] * 3 + [_I] * 4 + [_P], _I),
    # coords, valid, scratch, out_coords, out_valid, k, cap, geom, stream
    "di_downsample_sites": ([_P] * 5 + [_I] * 2 + [ctypes.POINTER(_I), _P], _I),
    # nbr, inv, ko, taps, k_in, stream
    "di_inverse_table": ([_P] * 2 + [_I] * 3 + [_P], _I),
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
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every nvcc process; raise on the first failure."""
    outs = [p.communicate() for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")
    return "".join(out + err for out, err in outs)


def build(verbose: bool = False) -> str:
    """Compile the kernels if no build of these sources exists; returns the
    library path. One ``nvcc -c`` per source, all started together, then
    one link. ``verbose`` adds ``-Xptxas -v`` (registers, spills) and
    prints the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libdi_kernels_{_source_digest()}.so")
    if os.path.exists(lib) and not verbose:
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        log = _run([
            subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", o, os.path.join(CSRC_DIR, s)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s, o in zip(SOURCES, objs)
        ])
        so = os.path.join(tmp, "lib.so")
        _run([subprocess.Popen([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
        if verbose:
            print(log)
        os.replace(so, lib)  # atomic: a concurrent build never sees half a file
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


def fp32_numerics() -> None:
    """Set the process's numerics to what the port states and its checks
    hold: fp32 matmuls and cuDNN convolutions (PyTorch's default runs cuDNN
    convolutions in TF32), and cuDNN autotuning (its default heuristic picks
    FFT convolutions for the fp32 3x3 BEV convs, 60x slower on an H100).
    Every entry point that runs the model on the card calls it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True


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
