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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda_lib

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


def local_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, kernel: int
) -> torch.Tensor:
    """Plain version: materialises the logit map."""
    c = key.shape[-1]
    logits = local_similar(query, key, kernel)
    attn = torch.softmax(logits / math.sqrt(c), dim=-1)
    return local_weighting(value, attn, kernel)


def _launch(q, k, v, kernel):
    b, h, w, c = q.shape
    out = torch.empty_like(q)
    code = cuda_lib.library().di_local_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, w, c, kernel, 1.0 / math.sqrt(c), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(code, "local_attn_fwd")
    local_attn_fwd.launches += 1
    return out


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
    @staticmethod
    def forward(ctx, q, k, v, kernel):
        ctx.kernel = kernel
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, kernel)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        return (*local_attn_bwd(q, k, v, grad, ctx.kernel), None)


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
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: int
) -> torch.Tensor:
    """K2 wrapper. q, k, v [B, H, W, C] f32 (NHWC) -> [B, H, W, C]."""
    if q.device.type == "cpu":
        return local_attention(q, k, v, kernel)
    return _LocalAttnFwd.apply(*_check("local_attn_fwd", (q, k, v), kernel), kernel)


def local_attn_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, kernel: int
):
    """K2 backward wrapper. q, k, v and dO [B, H, W, C] f32 (NHWC) ->
    (dq, dk, dv)."""
    if q.device.type == "cpu":
        return local_attention_bwd(q, k, v, dout, kernel)
    return _launch_bwd(*_check("local_attn_bwd", (q, k, v, dout), kernel), kernel)


local_attn_fwd.launches = 0
local_attn_bwd.launches = 0
