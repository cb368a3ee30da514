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

``bf16=True`` (:func:`subm_conv_gemm_bf16`) computes what the Pallas kernel
computes by default: ``out[i] = sum_d bf16(bf16(feat[nbr[i, d]]) @
bf16(W[d]))``, each tap's product summed over Cin in fp32 and rounded to
bf16 (nearest, ties to even) before the fp32 sum over taps. With
``per_tap=False`` no tap's product is rounded: bf16 operands and one fp32
sum over taps and channels, the numerics of JAX's ``DI_SPARSE_IMPL=s2d``
(``ops/sparse_conv.py::subm_conv_s2d``). On a CUDA tensor it rounds the
features and weights to bf16 once (the features zero-padded to a multiple
of 16 channels, the weights transposed to ``[D, Cout, Cin]``) and launches
the bf16 kernel (``csrc/subm_conv_bf16.cu``, entry ``di_subm_conv_bf16``);
on a CPU tensor :func:`gathered_matmul` with ``bf16=True``. The two differ
only where their fp32 sums over Cin, taken in different orders, round a
tap's product to neighbouring bf16 values (1e-4 of the output's scale). Its
d/dfeat is the same bf16 conv over the inverse table with ``W[d]^T`` and its
d/dW :func:`subm_conv_wgrad` on the features rounded to bf16, as JAX's
``_banded_bwd`` (``sparse_conv_banded.py:208-249``).
:func:`subm_conv_gemm_bf16` counts every launch of the bf16 kernel,
d/dfeat's included.

``ovf`` (a ``[]`` bool tensor on the features' device, the banded plan's
overflow flag, ``ops/sparse_conv.py::banded_overflow``) makes a bf16 call
compute fp32 where it is set, as JAX's ``_banded_apply`` falls back to the
fp32 gather (``:189-194``), d/dfeat too. No host sync: both kernels are
launched (the fp32 one through ``di_subm_conv_gemm_gated``, counted in
``subm_conv_gemm.launches``, or ``subm_conv_dgrad``'s), each reads the flag
and only one computes;
:func:`taken` counts on the device which one did.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import torch

from . import cuda_lib, flops

# per device: int32 [convs the fp32 kernel computed, convs the bf16 kernel
# computed] among the calls given an overflow flag (:func:`taken`)
_TAKEN: dict = {}

# rows of the table one wgrad block walks (32 tiles of the kernel's 32 rows);
# it sets the number of partials the second pass sums
WGRAD_ROWS_PER_BLOCK = 1024


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest, ties to even) and back to fp32."""
    return x.to(torch.bfloat16).float()


def taken(device) -> torch.Tensor:
    """int32 ``[2]`` on ``device``: of the convs given an overflow flag
    (``ovf``), how many the fp32 kernel and how many the bf16 kernel
    computed; each kernel adds one where its gate lets it run (on the CPU,
    the plain version). Zero it with ``.zero_()``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _TAKEN:
        _TAKEN[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _TAKEN[device]


def gathered_matmul(
    features: torch.Tensor,
    nbr: torch.Tensor,
    weights: torch.Tensor,
    valid_out: torch.Tensor,
    bf16: bool = False,
    per_tap: bool = True,
) -> torch.Tensor:
    """Plain version: one row gather and one matmul; with ``bf16``, the
    features and weights rounded to bf16, and with ``per_tap`` one fp32
    matmul per tap, each tap's product rounded to bf16, then the fp32 sum
    over taps (without it, one fp32 matmul).

    features [K, Cin]; nbr [Ko, D] (K = miss); weights [D, Cin, Cout] or
    [D*Cin, Cout]; valid_out [Ko] bool -> [Ko, Cout].
    """
    kin, cin = features.shape
    table = torch.cat([features, features.new_zeros(1, cin)], 0)
    g = table[nbr.clamp(max=kin).long()]  # [Ko, D, Cin]
    if bf16 and per_tap:
        w = round_bf16(weights.reshape(nbr.shape[1], cin, -1))
        out = round_bf16(torch.einsum("kdc,dco->kdo", round_bf16(g), w)).sum(1)
    elif bf16:
        out = round_bf16(g).reshape(g.shape[0], -1) @ round_bf16(weights.reshape(-1, weights.shape[-1]))
    else:
        out = g.reshape(g.shape[0], -1) @ weights.reshape(-1, weights.shape[-1])
    return torch.where(valid_out[:, None], out, out.new_zeros(()))


def plain_conv(features, nbr, weights, valid_out, bf16=False, per_tap=True, ovf=None) -> torch.Tensor:
    """The plain version of :func:`subm_conv_gemm`'s forward, the overflow
    flag included: :func:`gathered_matmul`, fp32 where ``ovf`` is set."""
    out = gathered_matmul(features, nbr, weights, valid_out, bf16, per_tap)
    if not bf16 or ovf is None:
        return out
    return torch.where(ovf, gathered_matmul(features, nbr, weights, valid_out), out)


def gathered_wgrad(features: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain d/dW: ``dW[d] = feat[nbr[:, d]]^T @ dy``, one row gather and one
    matmul per tap. features [K, Cin]; nbr [Ko, D] (K = miss); dy [Ko, Cout]
    -> [D, Cin, Cout]."""
    kin, cin = features.shape
    table = torch.cat([features, features.new_zeros(1, cin)], 0)
    idx = nbr.clamp(max=kin).long()
    return torch.stack([table[idx[:, d]].T @ dy for d in range(nbr.shape[1])])


def _launch(features, nbr, weights, valid_out, out, gate=None):
    """The fp32 kernel into ``out``; with ``gate``, only where it is set."""
    ko, taps = nbr.shape
    kin, cin = features.shape
    lib = cuda_lib.library()
    args = (features.data_ptr(), nbr.data_ptr(), weights.data_ptr(), valid_out.data_ptr(), out.data_ptr(),
            kin, ko, taps, cin, out.shape[1])
    stream = cuda_lib.stream_ptr(features.device)
    if gate is None:
        code = lib.di_subm_conv_gemm(*args, stream)
    else:
        code = lib.di_subm_conv_gemm_gated(*args, gate.data_ptr(), taken(gate.device).data_ptr(), stream)
    cuda_lib.check(code, "subm_conv_gemm")


def bf16_operand(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest, ties to even), its last dimension
    zero-padded to ``k``, contiguous: one cast (and a fill) a call."""
    if x.shape[-1] == k:
        return x.to(torch.bfloat16, memory_format=torch.contiguous_format)
    out = x.new_zeros(*x.shape[:-1], k, dtype=torch.bfloat16)
    out[..., : x.shape[-1]] = x
    return out


def _launch_bf16(x, table, w_nk, valid_out, per_tap, out, gate=None):
    """The bf16 kernel into ``out``: x [K, Cin] fp32 over ``table`` with
    ``w_nk`` [D, Cout, Cin] fp32 (each tap's W^T); with ``gate``, only where
    it is clear."""
    ko, taps = table.shape
    kin, cin = x.shape
    cin_p = -(-cin // 16) * 16  # the MMA depth
    xb, wb = bf16_operand(x, cin_p), bf16_operand(w_nk, cin_p)
    gate_ptr = taken_ptr = None
    if gate is not None:
        gate_ptr, taken_ptr = gate.data_ptr(), taken(gate.device).data_ptr() + 4
    code = cuda_lib.library().di_subm_conv_bf16(
        xb.data_ptr(), table.data_ptr(), wb.data_ptr(), valid_out.data_ptr(), out.data_ptr(),
        kin, ko, taps, cin_p, out.shape[1], int(per_tap), gate_ptr, taken_ptr, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(code, "subm_conv_gemm_bf16")


def _run(x, table, w, w_nk, valid_out, bf16, per_tap, ovf, counter):
    """One forward conv (or d/dfeat) on the card: ``w`` [D, Cin, Cout] for
    the fp32 kernel, ``w_nk`` (its [D, Cout, Cin] view) for the bf16 one;
    with ``bf16`` and ``ovf``, both, each gated by the flag."""
    out = torch.empty(table.shape[0], w.shape[-1], device=x.device, dtype=torch.float32)
    if not bf16:
        _launch(x, table, w, valid_out, out)
        counter.launches += 1
        return out
    if ovf is not None:
        if ovf.dtype != torch.bool or ovf.numel() != 1 or ovf.device != x.device:
            raise ValueError(f"subm_conv_gemm: ovf must be one bool on {x.device}")
        _launch(x, table, w, valid_out, out, gate=ovf)
        counter.launches += 1
    _launch_bf16(x, table, w_nk, valid_out, per_tap, out, gate=ovf)
    subm_conv_gemm_bf16.launches += 1
    return out


def _tally_plain(bf16, ovf):
    if bf16 and ovf is not None:
        taken(ovf.device).add_(torch.stack([ovf, ~ovf]).int())


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


def subm_conv_dgrad(dy: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor, bf16: bool = False,
                    per_tap: bool = True, ovf: torch.Tensor | None = None) -> torch.Tensor:
    """d/dfeat of K1: the forward kernel (the bf16 one with ``bf16``, as the
    forward's ``per_tap`` and ``ovf``) over the inverse table with
    ``W[d]^T``. dy [Ko, Cout] (invalid rows zeroed); inv [K, D] int32 (Ko =
    miss); weights [D, Cin, Cout] -> [K, Cin]."""
    if flops.counting:
        return counted_ops().dgrad(dy, inv, weights, bf16, per_tap, ovf)
    return _dgrad(dy, inv, weights, bf16, per_tap, ovf)


def _dgrad(dy, inv, weights, bf16=False, per_tap=True, ovf=None):
    wt = weights.transpose(1, 2).contiguous()
    every = torch.ones(inv.shape[0], dtype=torch.bool, device=dy.device)
    if dy.device.type == "cpu":
        _tally_plain(bf16, ovf)
        return plain_conv(dy, inv, wt, every, bf16, per_tap, ovf)
    _check("subm_conv_dgrad", dy, inv, wt, every)
    return _run(dy, inv, wt, weights, every, bf16, per_tap, ovf, subm_conv_dgrad)


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


def _forward(features, nbr, weights, valid_out, bf16, per_tap, ovf):
    if flops.counting:
        return counted_ops().gemm(features, nbr, weights, valid_out, bf16, per_tap, ovf)
    return _gemm(features, nbr, weights, valid_out, bf16, per_tap, ovf)


def _gemm(features, nbr, weights, valid_out, bf16=False, per_tap=True, ovf=None):
    if features.device.type == "cpu":
        _tally_plain(bf16, ovf)
        return plain_conv(features, nbr, weights, valid_out, bf16, per_tap, ovf)
    _check("subm_conv_gemm", features, nbr, weights, valid_out)
    return _run(features, nbr, weights, weights.transpose(1, 2), valid_out, bf16, per_tap, ovf, subm_conv_gemm)


class _SubmConvGemm(torch.autograd.Function):
    """K1 with its backward route; on CPU tensors every step is the plain
    version, so the CPU tests hold the route itself against JAX."""

    @staticmethod
    def forward(ctx, features, nbr, weights, valid_out, inv, bf16, per_tap, ovf):
        ctx.bf16, ctx.per_tap = bf16, per_tap
        ctx.save_for_backward(features, nbr, weights, valid_out, inv, ovf)
        return _forward(features, nbr, weights, valid_out, bf16, per_tap, ovf)

    @staticmethod
    def backward(ctx, grad):
        features, nbr, weights, valid_out, inv, ovf = ctx.saved_tensors
        dy = torch.where(valid_out[:, None], grad, grad.new_zeros(())).contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            dfeat = subm_conv_dgrad(dy, inv, weights, ctx.bf16, ctx.per_tap, ovf)
        if ctx.needs_input_grad[2]:
            dw = subm_conv_wgrad(round_bf16(features) if ctx.bf16 else features, nbr, dy)
        return dfeat, None, dw, None, None, None, None, None


def subm_conv_gemm(
    features: torch.Tensor,
    nbr: torch.Tensor,
    weights: torch.Tensor,
    valid_out: torch.Tensor,
    inv: torch.Tensor | None = None,
    bf16: bool = False,
    per_tap: bool = True,
    ovf: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1 wrapper. features [K, Cin] f32; nbr [Ko, D] int32 (K = miss);
    weights [D, Cin, Cout] f32 in gather tap order; valid_out [Ko] bool;
    inv [K, D] int32, the inverse table, needed only for d/dfeat; ``bf16``:
    the bf16 variant (:func:`subm_conv_gemm_bf16`), each tap's product
    rounded to bf16 with ``per_tap``, fp32 where ``ovf`` (a ``[]`` bool
    tensor) is set."""
    if not (torch.is_grad_enabled() and (features.requires_grad or weights.requires_grad)):
        return _forward(features, nbr, weights, valid_out, bf16, per_tap, ovf)
    if features.requires_grad and (
        inv is None or inv.shape != (features.shape[0], nbr.shape[1]) or inv.dtype != torch.int32
    ):
        raise ValueError("subm_conv_gemm: d/dfeat needs the [K, D] int32 inverse table")
    return _SubmConvGemm.apply(features, nbr, weights, valid_out, inv, bf16, per_tap, ovf)


def subm_conv_gemm_bf16(
    features: torch.Tensor,
    nbr: torch.Tensor,
    weights: torch.Tensor,
    valid_out: torch.Tensor,
    inv: torch.Tensor | None = None,
    per_tap: bool = True,
    ovf: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1 on bf16 operands, each tap's product rounded to bf16 (the Pallas
    kernel's default numerics; JAX's ``s2d`` with ``per_tap=False``):
    :func:`subm_conv_gemm` with ``bf16=True``. Its ``.launches`` counts the
    bf16 kernel's launches, d/dfeat's too."""
    return subm_conv_gemm(features, nbr, weights, valid_out, inv, True, per_tap, ovf)


@functools.lru_cache(maxsize=None)
def counted_ops() -> SimpleNamespace:
    """The three kernels as custom operators (``di_port::subm_conv_*``),
    each with its operation count registered for ``FlopCounterMode``;
    registered on first use. The wrappers call them only while
    ``flops.counting`` is set."""
    from torch.library import custom_op
    from torch.utils.flop_counter import register_flop_formula

    @custom_op("di_port::subm_conv_gemm", mutates_args=())
    def gemm(features: torch.Tensor, nbr: torch.Tensor, weights: torch.Tensor, valid_out: torch.Tensor,
             bf16: bool, per_tap: bool, ovf: Optional[torch.Tensor]) -> torch.Tensor:
        return _gemm(features, nbr, weights, valid_out, bf16, per_tap, ovf)

    @custom_op("di_port::subm_conv_dgrad", mutates_args=())
    def dgrad(dy: torch.Tensor, inv: torch.Tensor, weights: torch.Tensor, bf16: bool, per_tap: bool,
              ovf: Optional[torch.Tensor]) -> torch.Tensor:
        return _dgrad(dy, inv, weights, bf16, per_tap, ovf)

    @custom_op("di_port::subm_conv_wgrad", mutates_args=())
    def wgrad(features: torch.Tensor, nbr: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
        return _wgrad(features, nbr, dy)

    @register_flop_formula(torch.ops.di_port.subm_conv_gemm, get_raw=True)
    def _gemm_ops(features, nbr, weights, valid_out, bf16, per_tap, ovf, out_val=None):
        return flops.k1_ops(flops.k1_hits(nbr, features.shape[0], valid_out), features.shape[1], weights.shape[-1])

    @register_flop_formula(torch.ops.di_port.subm_conv_dgrad, get_raw=True)
    def _dgrad_ops(dy, inv, weights, bf16, per_tap, ovf, out_val=None):
        return flops.k1_ops(flops.k1_hits(inv, dy.shape[0]), dy.shape[1], weights.shape[1])

    @register_flop_formula(torch.ops.di_port.subm_conv_wgrad, get_raw=True)
    def _wgrad_ops(features, nbr, dy, out_val=None):
        return flops.k1_ops(flops.k1_hits(nbr, features.shape[0]), features.shape[1], dy.shape[1])

    return SimpleNamespace(gemm=gemm, dgrad=dgrad, wgrad=wgrad)


subm_conv_gemm.launches = 0
subm_conv_gemm_bf16.launches = 0
subm_conv_dgrad.launches = 0
subm_conv_wgrad.launches = 0
