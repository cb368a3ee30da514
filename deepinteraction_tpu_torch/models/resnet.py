"""ResNet image backbone (port of ``deepinteraction_tpu/models/resnet.py``;
torchvision layout, stride on the 3x3 conv). NHWC in and out; the convs run
on cuDNN/oneDNN through ``F.conv2d``, as the JAX package leaves them to
XLA. Eval-only (BN on running statistics)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.has_down = stride != 1 or cin != features
        if self.has_down:
            self.downsample_conv = Conv2d(cin, features, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return F.relu(y + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = Conv2d(cin, features, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.has_down = stride != 1 or cin != out
        if self.has_down:
            self.downsample_conv = Conv2d(cin, out, 1, stride, 0, bias=False)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = self.downsample_bn(self.downsample_conv(x)) if self.has_down else x
        return F.relu(y + idt)


_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
}
WIDTHS = (64, 128, 256, 512)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, out_indices=(0, 1, 2, 3)):
        super().__init__()
        block, stage_blocks = _SPECS[depth]
        self.out_indices = tuple(out_indices)
        self.stage_blocks = stage_blocks
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, (n, w) in enumerate(zip(stage_blocks, WIDTHS)):
            for j in range(n):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_{j}", block(cin, w, stride))
                cin = w * block.expansion
        self.out_channels = tuple(w * block.expansion for w in WIDTHS)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for i, n in enumerate(self.stage_blocks):
            for j in range(n):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            if i in self.out_indices:
                outs.append(x)
        return outs
