"""K1: sparse convolution as a gather-GEMM, forward and backward, with the
plain version of each kernel.

``subm_conv_gemm`` computes ``out[i] = sum_d feat[nbr[i, d]] @ W[d]`` with a
zero row for a miss (``nbr == K``) and zeroed invalid output rows. Its
backward, with ``dy`` the output gradient with invalid rows zeroed:

- d/dfeat is the same conv over the inverse table (``inv[j, d] = i`` where
  ``nbr[i, d] = j``, ``Ko`` for a miss) with ``W[d]^T``:
  :func:`subm_conv_dgrad`, which launches the forward kernel. The caller
  passes ``inv`` (``ops/sparse_conv.py``: ``mirror_table`` for a
  submanifold table, ``inverse_table`` for a strided one). It is skipped
  where the features need no gradient (the voxel features of ``conv_input``).
- d/dW is ``dW[d] = feat[nbr[:, d]]^T @ dy``: :func:`subm_conv_wgrad`.

On a CPU tensor each wrapper runs its plain PyTorch version
(:func:`gathered_matmul`, the counterpart of ``deepinteraction_tpu/ops/
sparse_conv.py::gathered_matmul``; :func:`gathered_wgrad`, the tap loop of
``deepinteraction_tpu/ops/sparse_conv_banded.py::_banded_bwd``). On a CUDA
tensor it launches the Hopper kernel of ``csrc/subm_conv.cu`` or raises;
there is no fallback.

The kernels replace the Pallas kernel ``deepinteraction_tpu/ops/
sparse_conv_banded.py::_banded_kernel_call`` (forward and d/dfeat) and the
d/dW of ``_banded_bwd``; the source notes say what bounds them on the H100
and what their designs do about it. The forward kernel (and so d/dfeat)
and d/dW multiply on the tensor cores in split TF32 (three TF32 products
per fp32 product) and keep fp32 accuracy, so they agree with the plain
versions to fp32 summation-order error (tolerance 1e-4 relative to the
output's scale). d/dW adds its per-block partials in a fixed order: two
calls give the same bits. Each wrapper counts its launches in
``.launches``. While ``ops/flops.py::counting_kernels`` is active, each
wrapper runs through a custom operator that ``FlopCounterMode`` counts at
2 * Cin * Cout a hit of its table (:func:`counted_ops`).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from . import cuda_lib, flops

# rows of the table one wgrad block walks (32 tiles of the kernel's 32 rows);
# it sets the number of partials the second pass sums
WGRAD_ROWS_PER_BLOCK = 1024


def gathered_matmul(
    features: torch.Tensor,
    nbr: torch.Tensor,
    weights: torch.Tensor,
    valid_out: torch.Tensor,
) -> torch.Tensor:
    """Plain version: one row gather and one matmul.

    features [K, Cin]; nbr [Ko, D] (K = miss); weights [D, Cin, Cout] or
    [D*Cin, Cout]; valid_out [Ko] bool -> [Ko, Cout].
    """
    kin, cin = features.shape
    table = torch.cat([features, features.new_zeros(1, cin)], 0)
    g = table[nbr.clamp(max=kin).long()]  # [Ko, D, Cin]
    out = g.reshape(g.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])
    return torch.where(valid_out[:, None], out, out.new_zeros(()))


def gathered_wgrad(features: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain d/dW: ``dW[d] = feat[nbr[:, d]]^T @ dy``, one row gather and one
    matmul per tap. features [K, Cin]; nbr [Ko, D] (K = miss); dy [Ko, Cout]
    -> [D, Cin, Cout]."""
    kin, cin = features.shape
    table = torch.cat([features, features.new_zeros(1, cin)], 0)
    idx = nbr.clamp(max=kin).long()
    return torch.stack([table[idx[:, d]].T @ dy for d in range(nbr.shape[1])])


def _launch(features, nbr, weights, valid_out):
    ko, taps = nbr.shape
    kin, cin = features.shape
    cout = weights.shape[-1]
    out = torch.empty(ko, cout, device=features.device, dtype=torch.float32)
    code = cuda_lib.library().di_subm_conv_gemm(
        features.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
        valid_out.data_ptr(), out.data_ptr(),
        kin, ko, taps, cin, cout, cuda_lib.stream_ptr(features.device),
    )
    cuda_lib.check(code, "subm_conv_gemm")
    return out


def _check(name, features, nbr, weights, valid_out):
    ko, taps = nbr.shape
    cin = features.shape[1]
    if (
        features.dtype != torch.float32
        or weights.dtype != torch.float32
        or nbr.dtype != torch.int32
        or valid_out.dtype != torch.bool
    ):
        raise TypeError(f"{name}: want f32 features/weights, int32 tables, bool valid")
    if weights.dim() != 3 or weights.shape[:2] != (taps, cin) or valid_out.shape != (ko,):
        raise ValueError(
            f"{name}: shapes features {tuple(features.shape)}, table "
            f"{tuple(nbr.shape)}, weights {tuple(weights.shape)}, valid "
            f"{tuple(valid_out.shape)} do not agree"
        )
    cuda_lib.require_cuda(name, features, nbr, weights, valid_out)


def subm_conv_dgrad(dy: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """d/dfeat of K1: the forward kernel over the inverse table with
    ``W[d]^T``. dy [Ko, Cout] (invalid rows zeroed); inv [K, D] int32 (Ko =
    miss); weights [D, Cin, Cout] -> [K, Cin]."""
    if flops.counting:
        return counted_ops().dgrad(dy, inv, weights)
    return _dgrad(dy, inv, weights)


def _dgrad(dy, inv, weights):
    wt = weights.transpose(1, 2).contiguous()
    every = torch.ones(inv.shape[0], dtype=torch.bool, device=dy.device)
    if dy.device.type == "cpu":
        return gathered_matmul(dy, inv, wt, every)
    _check("subm_conv_dgrad", dy, inv, wt, every)
    out = _launch(dy, inv, wt, every)
    subm_conv_dgrad.launches += 1
    return out


def subm_conv_wgrad(features: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """d/dW of K1. features [K, Cin]; nbr [Ko, D] int32 (K = miss); dy
    [Ko, Cout] (invalid rows zeroed) -> [D, Cin, Cout]."""
    if flops.counting:
        return counted_ops().wgrad(features, nbr, dy)
    return _wgrad(features, nbr, dy)


def _wgrad(features, nbr, dy):
    if features.device.type == "cpu":
        return gathered_wgrad(features, nbr, dy)
    if features.dtype != torch.float32 or dy.dtype != torch.float32 or nbr.dtype != torch.int32:
        raise TypeError("subm_conv_wgrad: want f32 features/dy, int32 nbr")
    ko, taps = nbr.shape
    kin, cin = features.shape
    if dy.dim() != 2 or dy.shape[0] != ko:
        raise ValueError(f"subm_conv_wgrad: dy {tuple(dy.shape)} vs nbr {tuple(nbr.shape)}")
    cuda_lib.require_cuda("subm_conv_wgrad", features, nbr, dy)
    cout = dy.shape[1]
    chunks = -(-ko // WGRAD_ROWS_PER_BLOCK)
    partial = torch.empty(max(chunks, 1), taps, cin, cout, device=dy.device, dtype=torch.float32)
    out = torch.empty(taps, cin, cout, device=dy.device, dtype=torch.float32)
    code = cuda_lib.library().di_subm_conv_wgrad(
        features.data_ptr(), nbr.data_ptr(), dy.data_ptr(), partial.data_ptr(),
        out.data_ptr(), kin, ko, taps, cin, cout, chunks,
        cuda_lib.stream_ptr(dy.device),
    )
    cuda_lib.check(code, "subm_conv_wgrad")
    subm_conv_wgrad.launches += 1
    return out


def _forward(features, nbr, weights, valid_out):
    if flops.counting:
        return counted_ops().gemm(features, nbr, weights, valid_out)
    return _gemm(features, nbr, weights, valid_out)


def _gemm(features, nbr, weights, valid_out):
    if features.device.type == "cpu":
        return gathered_matmul(features, nbr, weights, valid_out)
    _check("subm_conv_gemm", features, nbr, weights, valid_out)
    out = _launch(features, nbr, weights, valid_out)
    subm_conv_gemm.launches += 1
    return out


class _SubmConvGemm(torch.autograd.Function):
    """K1 with its backward route; on CPU tensors every step is the plain
    version, so the CPU tests hold the route itself against JAX."""

    @staticmethod
    def forward(ctx, features, nbr, weights, valid_out, inv):
        ctx.save_for_backward(features, nbr, weights, valid_out, inv)
        return _forward(features, nbr, weights, valid_out)

    @staticmethod
    def backward(ctx, grad):
        features, nbr, weights, valid_out, inv = ctx.saved_tensors
        dy = torch.where(valid_out[:, None], grad, grad.new_zeros(())).contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            dfeat = subm_conv_dgrad(dy, inv, weights)
        if ctx.needs_input_grad[2]:
            dw = subm_conv_wgrad(features, nbr, dy)
        return dfeat, None, dw, None, None


def subm_conv_gemm(
    features: torch.Tensor,
    nbr: torch.Tensor,
    weights: torch.Tensor,
    valid_out: torch.Tensor,
    inv: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1 wrapper. features [K, Cin] f32; nbr [Ko, D] int32 (K = miss);
    weights [D, Cin, Cout] f32 in gather tap order; valid_out [Ko] bool;
    inv [K, D] int32, the inverse table, needed only for d/dfeat."""
    if not (torch.is_grad_enabled() and (features.requires_grad or weights.requires_grad)):
        return _forward(features, nbr, weights, valid_out)
    if features.requires_grad and (
        inv is None or inv.shape != (features.shape[0], nbr.shape[1]) or inv.dtype != torch.int32
    ):
        raise ValueError("subm_conv_gemm: d/dfeat needs the [K, D] int32 inverse table")
    return _SubmConvGemm.apply(features, nbr, weights, valid_out, inv)


@functools.lru_cache(maxsize=None)
def counted_ops() -> SimpleNamespace:
    """The three kernels as custom operators (``di_port::subm_conv_*``),
    each with its operation count registered for ``FlopCounterMode``;
    registered on first use. The wrappers call them only while
    ``flops.counting`` is set."""
    from torch.library import custom_op
    from torch.utils.flop_counter import register_flop_formula

    @custom_op("di_port::subm_conv_gemm", mutates_args=())
    def gemm(features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor,
             valid_out: torch.Tensor) -> torch.Tensor:
        return _gemm(features, nbr, weights, valid_out)

    @custom_op("di_port::subm_conv_dgrad", mutates_args=())
    def dgrad(dy: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        return _dgrad(dy, inv, weights)

    @custom_op("di_port::subm_conv_wgrad", mutates_args=())
    def wgrad(features: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
        return _wgrad(features, nbr, dy)

    @register_flop_formula(torch.ops.di_port.subm_conv_gemm, get_raw=True)
    def _gemm_ops(features, nbr, weights, valid_out, out_val=None):
        return flops.k1_ops(flops.k1_hits(nbr, features.shape[0], valid_out), features.shape[1], weights.shape[-1])

    @register_flop_formula(torch.ops.di_port.subm_conv_dgrad, get_raw=True)
    def _dgrad_ops(dy, inv, weights, out_val=None):
        return flops.k1_ops(flops.k1_hits(inv, dy.shape[0]), dy.shape[1], weights.shape[1])

    @register_flop_formula(torch.ops.di_port.subm_conv_wgrad, get_raw=True)
    def _wgrad_ops(features, nbr, dy, out_val=None):
        return flops.k1_ops(flops.k1_hits(nbr, features.shape[0]), features.shape[1], dy.shape[1])

    return SimpleNamespace(gemm=gemm, dgrad=dgrad, wgrad=wgrad)


subm_conv_gemm.launches = 0
subm_conv_dgrad.launches = 0
subm_conv_wgrad.launches = 0
