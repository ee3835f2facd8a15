"""Caffe-style ResNet-50/101 backbone with frozen BatchNorm.

Port of ``upsnet_tpu/models/resnet.py``: ResNet v1 bottlenecks with the
downsampling stride on the FIRST 1x1 conv (caffe layout), BN frozen into
affines, 3x3/2 max pool with padding 1. Backbone DCN (``dcn_stages``) and
GroupNorm are not ported yet; the predict path uses neither.
"""

from __future__ import annotations

import torch
from torch import nn

from upsnet_torch.models.layers import Conv2d, FrozenBatchNorm

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    # 1 block per stage: same strides and interfaces, for tests
    "resnet_test": (1, 1, 1, 1),
}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        out_ch = features * 4
        if downsample:
            self.shortcut_conv = Conv2d(cin, out_ch, 1, stride, dtype=dtype)
            self.shortcut_bn = FrozenBatchNorm(out_ch, dtype)
        else:
            self.shortcut_conv = None
        self.conv1 = Conv2d(cin, features, 1, stride, dtype=dtype)
        self.bn1 = FrozenBatchNorm(features, dtype)
        self.conv2 = Conv2d(features, features, 3, 1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(features, dtype)
        self.conv3 = Conv2d(features, out_ch, 1, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_ch, dtype)

    def forward(self, x):
        residual = x
        if self.shortcut_conv is not None:
            residual = self.shortcut_bn(self.shortcut_conv(x))
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + residual)


class ResNetBackbone(nn.Module):
    """Returns (C2, C3, C4, C5) at strides (4, 8, 16, 32), NCHW."""

    def __init__(self, depth: str = "resnet50", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype)
        self.pool = nn.MaxPool2d(3, 2, 1)
        self.block_names = []
        cin = 64
        for stage_i, (n_blocks, width) in enumerate(
                zip(STAGE_BLOCKS[depth], (64, 128, 256, 512)), start=2):
            names = []
            for b in range(n_blocks):
                name = f"res{stage_i}_{b}"
                # res2 keeps stride 1 (its input is already at stride 4)
                stride = 2 if (b == 0 and stage_i > 2) else 1
                self.add_module(name, Bottleneck(cin, width, stride, b == 0, dtype))
                cin = width * 4
                names.append(name)
            self.block_names.append(names)

    def forward(self, x):  # (B, 3, H, W), mean-subtracted BGR
        x = torch.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = self.pool(x)
        outs = []
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return tuple(outs)
