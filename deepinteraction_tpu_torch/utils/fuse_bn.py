"""Inference-time Conv+BN folding (the port's counterpart of
``deepinteraction_tpu/utils/fuse_bn.py``; reference
``tools/misc/fuse_conv_bn.py``).

The port names its modules after the Flax tree, so JAX's rule carries over:
wherever a module holds a sibling ``conv`` (a ``Conv2d``: a Flax
``kernel``) and ``bn`` (a ``BatchNorm``), the BN's affine and running
statistics are folded into the conv's weight and the BN is neutralised:
``weight = 1``, ``running_mean = 0``, ``running_var = 1 - eps`` (so
``rsqrt(var + eps) == 1``), and ``bias`` the folded bias, since the conv
may have none (a conv followed by a norm is bias-free). That is
the ``ConvBNReLU`` pairs: the MMRI projections and integrations and the
decoder's head convs. The factor scales the output channels, dim 0 of
the ``Conv2d`` weight ``[Cout, Cin, kh, kw]`` (Flax's last dim of
``kernel``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.layers import BatchNorm


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> int:
    """Fold every sibling ``conv`` + ``bn`` pair of ``model`` in place;
    returns the number of pairs folded."""
    count = 0
    for mod in model.modules():
        conv, bn = getattr(mod, "conv", None), getattr(mod, "bn", None)
        if not (isinstance(conv, nn.Conv2d) and isinstance(bn, BatchNorm)):
            continue
        factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        conv_bias = conv.bias if conv.bias is not None else torch.zeros_like(bn.running_mean)
        conv.weight.mul_(factor.reshape((-1,) + (1,) * (conv.weight.dim() - 1)))
        bn.bias.copy_((conv_bias - bn.running_mean) * factor + bn.bias)
        if conv.bias is not None:
            conv.bias.zero_()
        bn.weight.fill_(1.0)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
        count += 1
    return count
