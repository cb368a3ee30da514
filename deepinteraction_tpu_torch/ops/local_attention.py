"""K2: k x k local (sliding-window) attention on NHWC maps, and its plain
version.

``local_attn_fwd(q, k, v, kernel)`` is ``softmax(q . k / sqrt(C)) @ v`` over
each pixel's kernel x kernel window. A tap outside the map reads a zero key
(logit 0, still counted in the softmax) and a zero value, as the reference
CUDA extension does.

- On a CPU tensor it runs :func:`local_attention`, the plain version, which
  mirrors ``deepinteraction_tpu/ops/local_attention.py::local_attention``.
- On a CUDA tensor it launches the Hopper kernel of
  ``csrc/local_attention.cu`` or raises. There is no fallback.

The kernel replaces the Pallas kernel
``deepinteraction_tpu/ops/local_attention_pallas.py::_kernel``; its source
note says what bounds it on the H100 and what its design does about it. It
multiplies on the tensor cores in split TF32 (three TF32 products per fp32
product), which keeps fp32 accuracy, so it agrees with the plain version to
fp32 rounding (tolerance 2e-5 absolute and relative). It takes odd kernel
sizes up to ``MAX_KERNEL`` (the model uses 5 and 9).

``local_attn_bwd(q, k, v, dout, kernel)`` is its backward, dq, dk and dv. On
a CUDA tensor it launches the two passes of ``csrc/local_attention.cu``
(pass A per query tile: dq, and each query's log-sum-exp and D; pass B per
key tile: dk and dv), which multiply on the tensor cores in split TF32 like
the forward; the JAX package re-differentiates its XLA oracle
(``local_attention_pallas.py::_bwd``). On a CPU tensor it runs autograd of
:func:`local_attention`, its plain version. ``local_attn_fwd`` keeps q, k
and v for it, so a train step through K2 runs both kernels. Against the
plain version it agrees within 1e-4 of each output's scale, and it gives the
same bits on every call (no atomics).

``local_attn_fwd_bf16`` (``local_attn_fwd(..., bf16=True)``) computes what
the Pallas kernel computes by default (``DI_LOCATT_MXU=bf16``): q, k and v
rounded to bf16, the logits' products summed in fp32 and times 1/sqrt(C),
the softmax in fp32, the probabilities normalised and then rounded to bf16,
their products with v summed in fp32. On a CUDA tensor it launches the
bf16 kernel of ``csrc/local_attention_bf16.cu`` (``di_local_attn_fwd_bf16``:
q, k and v rounded to bf16 once as they are staged into shared memory, 8 x 16
query tiles, producer and consumer warps; :func:`bf16_kernel_info` gives its
registers and occupancy), on a CPU tensor
:func:`local_attention` with ``bf16=True``; the two differ only where
fp32 sums taken in different orders round to neighbouring bf16 values
(1e-4 of the output's scale). Its backward is the fp32 one,
:func:`local_attn_bwd` on the fp32 q, k and v, as JAX's custom VJP
re-differentiates its fp32 oracle.

While ``ops/flops.py::counting_kernels`` is active, both wrappers run
through custom operators that ``FlopCounterMode`` counts at 4 k^2 C (forward)
and 10 k^2 C (backward) a pixel (:func:`counted_ops`), on either device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import cuda_lib, flops

# largest window the kernel takes: its k*k logits live in registers
MAX_KERNEL = 9


def local_similar(query: torch.Tensor, key: torch.Tensor, kernel: int) -> torch.Tensor:
    """[B, H, W, C] x [B, H, W, C] -> logits [B, H, W, kernel*kernel]."""
    _, h, w, _ = query.shape
    r = kernel // 2
    kp = F.pad(key, (0, 0, r, r, r, r))
    outs = [
        (query * kp[:, dh : dh + h, dw : dw + w, :]).sum(-1)
        for dh in range(kernel)
        for dw in range(kernel)
    ]
    return torch.stack(outs, -1)


def local_weighting(value: torch.Tensor, weight: torch.Tensor, kernel: int) -> torch.Tensor:
    """[B, H, W, C] values, [B, H, W, kernel*kernel] weights -> [B, H, W, C]."""
    _, h, w, _ = value.shape
    r = kernel // 2
    vp = F.pad(value, (0, 0, r, r, r, r))
    out = torch.zeros_like(value)
    t = 0
    for dh in range(kernel):
        for dw in range(kernel):
            out = out + weight[..., t : t + 1] * vp[:, dh : dh + h, dw : dw + w, :]
            t += 1
    return out


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def local_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, kernel: int, bf16: bool = False
) -> torch.Tensor:
    """Plain version: materialises the logit map. With ``bf16``, as the
    Pallas kernel's default: q, k, v rounded to bf16, logits times
    ``1/sqrt(C)``, ``p / sum(p)`` rounded to bf16, fp32 sums."""
    c = key.shape[-1]
    if not bf16:
        logits = local_similar(query, key, kernel)
        attn = torch.softmax(logits / math.sqrt(c), dim=-1)
        return local_weighting(value, attn, kernel)
    logits = local_similar(_round_bf16(query), _round_bf16(key), kernel) * (1.0 / math.sqrt(c))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    return local_weighting(_round_bf16(value), _round_bf16(p / p.sum(-1, keepdim=True)), kernel)


def _launch(q, k, v, kernel, bf16):
    b, h, w, c = q.shape
    out = torch.empty_like(q)
    lib = cuda_lib.library()
    code = (lib.di_local_attn_fwd_bf16 if bf16 else lib.di_local_attn_fwd)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, w, c, kernel, 1.0 / math.sqrt(c), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(code, "local_attn_fwd_bf16" if bf16 else "local_attn_fwd")
    (local_attn_fwd_bf16 if bf16 else local_attn_fwd).launches += 1
    return out


def bf16_kernel_info(kernel: int) -> dict:
    """Registers and spilled bytes a thread, shared bytes and threads a
    block, blocks and warps an SM of the kernel that :func:`local_attn_fwd_bf16`
    launches for ``kernel`` with 16-byte loads (C a multiple of 4, the four
    maps 16-byte aligned). Needs the card."""
    out = (ctypes.c_int * 5)()
    cuda_lib.check(cuda_lib.library().di_local_attn_fwd_bf16_info(kernel, out), "local_attn_fwd_bf16_info")
    regs, spill, smem, threads, blocks = out
    return dict(registers=regs, spill_bytes=spill, shared_bytes=smem, threads=threads, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32)


def local_attention_bwd(q, k, v, dout, kernel: int):
    """Plain backward: autograd of :func:`local_attention` -> (dq, dk, dv)."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(local_attention(*qkv, kernel), qkv, dout)


def _launch_bwd(q, k, v, dout, kernel):
    b, h, w, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lse, dsum = (q.new_empty(b, h, w) for _ in range(2))  # each query's log-sum-exp and D
    code = cuda_lib.library().di_local_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), lse.data_ptr(), dsum.data_ptr(), b, h, w, c, kernel, 1.0 / math.sqrt(c),
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(code, "local_attn_bwd")
    local_attn_bwd.launches += 1
    return dq, dk, dv


class _LocalAttnFwd(torch.autograd.Function):
    """The forward (fp32 or bf16) with the fp32 backward; q, k and v are
    kept in fp32."""

    @staticmethod
    def forward(ctx, q, k, v, kernel, bf16):
        ctx.kernel = kernel
        ctx.save_for_backward(q, k, v)
        if flops.counting:
            return counted_ops().fwd(q, k, v, kernel, bf16)
        return _fwd(q, k, v, kernel, bf16)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        return (*local_attn_bwd(q, k, v, grad, ctx.kernel), None, None)


def _check(name, tensors, kernel):
    """Raise unless ``tensors`` are equal-shaped [B, H, W, C] float32 CUDA
    tensors and ``kernel`` is a size the kernels take; returns them
    contiguous."""
    shapes = [tuple(t.shape) for t in tensors]
    if len(set(shapes)) != 1 or len(shapes[0]) != 4:
        raise ValueError(f"{name}: want equal [B, H, W, C] shapes, got {shapes}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: want float32 tensors")
    if kernel % 2 != 1 or not 1 <= kernel <= MAX_KERNEL:
        raise ValueError(f"{name}: kernel must be odd and at most {MAX_KERNEL}, got {kernel}")
    tensors = [t.contiguous() for t in tensors]
    cuda_lib.require_cuda(name, *tensors)
    return tensors


def local_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: int, bf16: bool = False
) -> torch.Tensor:
    """K2 wrapper. q, k, v [B, H, W, C] f32 (NHWC) -> [B, H, W, C];
    ``bf16``: the bf16 variant (:func:`local_attn_fwd_bf16`)."""
    if flops.counting:  # either device, through the counted operators
        return _LocalAttnFwd.apply(q, k, v, kernel, bf16)
    if q.device.type == "cpu":
        # fp32: autograd of the plain version; bf16: its fp32 backward
        return _LocalAttnFwd.apply(q, k, v, kernel, bf16) if bf16 else local_attention(q, k, v, kernel)
    return _LocalAttnFwd.apply(*_check("local_attn_fwd", (q, k, v), kernel), kernel, bf16)


def local_attn_fwd_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: int) -> torch.Tensor:
    """K2 on bf16 operands (the Pallas kernel's default numerics), with the
    fp32 backward: :func:`local_attn_fwd` with ``bf16=True``."""
    return local_attn_fwd(q, k, v, kernel, bf16=True)


def local_attn_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, kernel: int
):
    """K2 backward wrapper. q, k, v and dO [B, H, W, C] f32 (NHWC) ->
    (dq, dk, dv)."""
    if flops.counting:
        return tuple(counted_ops().bwd(q, k, v, dout, kernel))
    return _bwd(q, k, v, dout, kernel)


def _fwd(q, k, v, kernel, bf16=False):
    if q.device.type == "cpu":
        return local_attention(q, k, v, kernel, bf16)
    return _launch(*_check("local_attn_fwd", (q, k, v), kernel), kernel, bf16)


def _bwd(q, k, v, dout, kernel):
    if q.device.type == "cpu":
        return local_attention_bwd(q, k, v, dout, kernel)
    return _launch_bwd(*_check("local_attn_bwd", (q, k, v, dout), kernel), kernel)


@functools.lru_cache(maxsize=None)
def counted_ops() -> SimpleNamespace:
    """K2 and its backward as custom operators (``di_port::local_attn_*``),
    each with its operation count registered for ``FlopCounterMode``;
    registered on first use. The wrappers call them only while
    ``flops.counting`` is set."""
    from torch.library import custom_op
    from torch.utils.flop_counter import register_flop_formula

    @custom_op("di_port::local_attn_fwd", mutates_args=())
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: int, bf16: bool) -> torch.Tensor:
        return _fwd(q, k, v, kernel, bf16)

    @custom_op("di_port::local_attn_bwd", mutates_args=())
    def bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
            kernel: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if q.device.type == "cpu":
            # the plain backward is autograd, which does not run where an
            # operator's body runs (below the autograd dispatch key); a new
            # thread starts from the default dispatch state
            with ThreadPoolExecutor(1) as pool:
                return tuple(pool.submit(local_attention_bwd, q, k, v, dout, kernel).result())
        return tuple(_bwd(q, k, v, dout, kernel))

    @register_flop_formula(torch.ops.di_port.local_attn_fwd, get_raw=True)
    def _fwd_ops(q, k, v, kernel, bf16, out_val=None):
        return flops.k2_ops(q.shape, kernel)

    @register_flop_formula(torch.ops.di_port.local_attn_bwd, get_raw=True)
    def _bwd_ops(q, k, v, dout, kernel, out_val=None):
        return flops.k2_ops(q.shape, kernel, backward=True)

    return SimpleNamespace(fwd=fwd, bwd=bwd)


local_attn_fwd.launches = 0
local_attn_fwd_bf16.launches = 0
local_attn_bwd.launches = 0
