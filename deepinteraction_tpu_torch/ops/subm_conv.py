"""K1: sparse convolution as a gather-GEMM (forward), and its plain version.

``subm_conv_gemm`` computes ``out[i] = sum_d feat[nbr[i, d]] @ W[d]`` with a
zero row for a miss (``nbr == K``) and zeroed invalid output rows.

- On a CPU tensor it runs :func:`gathered_matmul`, the plain PyTorch version
  (the counterpart of ``deepinteraction_tpu/ops/sparse_conv.py::
  gathered_matmul``).
- On a CUDA tensor it launches the Hopper kernel of ``csrc/subm_conv.cu`` or
  raises. There is no fallback.

The kernel replaces the Pallas kernel
``deepinteraction_tpu/ops/sparse_conv_banded.py::_banded_kernel_call``; its
source note says what bounds it on the H100 and what its design does about
it. The kernel multiplies in fp32, so it agrees with the plain version to
fp32 summation-order error (tolerance 1e-4 relative to the output's scale).
The backward is not ported yet (ROADMAP queue 2, K1 backward).
"""

from __future__ import annotations

import torch

from . import cuda_lib


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
    subm_conv_gemm.launches += 1
    return out


class _SubmConvGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, nbr, weights, valid_out):
        return _launch(features, nbr, weights, valid_out)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "subm_conv_gemm has no backward kernel yet (ROADMAP queue 2, "
            "K1 backward: dfeat = the same conv with W[mirror(d)]^T, "
            "dW tap-looped)"
        )


def subm_conv_gemm(
    features: torch.Tensor,
    nbr: torch.Tensor,
    weights: torch.Tensor,
    valid_out: torch.Tensor,
) -> torch.Tensor:
    """K1 wrapper. features [K, Cin] f32; nbr [Ko, D] int32 (K = miss);
    weights [D, Cin, Cout] f32 in gather tap order; valid_out [Ko] bool."""
    if features.device.type == "cpu":
        return gathered_matmul(features, nbr, weights, valid_out)
    ko, taps = nbr.shape
    cin = features.shape[1]
    if (
        features.dtype != torch.float32
        or weights.dtype != torch.float32
        or nbr.dtype != torch.int32
        or valid_out.dtype != torch.bool
    ):
        raise TypeError("subm_conv_gemm: want f32 features/weights, int32 nbr, bool valid")
    if weights.dim() != 3 or weights.shape[:2] != (taps, cin) or valid_out.shape != (ko,):
        raise ValueError(
            f"subm_conv_gemm: shapes features {tuple(features.shape)}, nbr "
            f"{tuple(nbr.shape)}, weights {tuple(weights.shape)}, valid "
            f"{tuple(valid_out.shape)} do not agree"
        )
    cuda_lib.require_cuda("subm_conv_gemm", features, nbr, weights, valid_out)
    return _SubmConvGemm.apply(features, nbr, weights, valid_out)


subm_conv_gemm.launches = 0
