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
computes in fp32, so it agrees with the plain version to fp32 rounding
(tolerance 2e-5 absolute and relative). The backward is not ported yet
(ROADMAP queue 2, K2 backward).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda_lib


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


class _LocalAttnFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kernel):
        return _launch(q, k, v, kernel)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "local_attn_fwd has no backward kernel yet (ROADMAP queue 2, "
            "K2 backward)"
        )


def local_attn_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: int
) -> torch.Tensor:
    """K2 wrapper. q, k, v [B, H, W, C] f32 (NHWC) -> [B, H, W, C]."""
    if q.device.type == "cpu":
        return local_attention(q, k, v, kernel)
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"local_attn_fwd: want equal [B, H, W, C] shapes, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise TypeError("local_attn_fwd: want float32 q, k, v")
    if kernel % 2 != 1 or kernel < 1:
        raise ValueError(f"local_attn_fwd: kernel must be odd, got {kernel}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    cuda_lib.require_cuda("local_attn_fwd", q, k, v)
    return _LocalAttnFwd.apply(q, k, v, kernel)


local_attn_fwd.launches = 0
