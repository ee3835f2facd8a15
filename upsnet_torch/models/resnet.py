"""Caffe-style ResNet-50/101 backbone.

Port of ``upsnet_tpu/models/resnet.py``: ResNet v1 bottlenecks with the
downsampling stride on the FIRST 1x1 conv (caffe layout, so every 3x3,
deformable or not, runs at stride 1), 3x3/2 max pool with padding 1. The
norm is ``make_norm(norm)``: BN frozen into affines (the reference's) or
GroupNorm 32. The ``-DCN`` variants swap the 3x3 conv of every bottleneck
in the stages of ``dcn_stages`` (of 3, 4, 5) for a deformable conv
without bias.
"""

from __future__ import annotations

import torch
from torch import nn

from upsnet_torch.models.layers import Conv2d, DeformConv, make_norm

STAGE_BLOCKS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    # 1 block per stage: same strides and interfaces, for tests
    "resnet_test": (1, 1, 1, 1),
}


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32,
                 norm: str = "frozen_bn", with_dcn: bool = False,
                 dcn_impl: str = "auto", dcn_max_dy: int = 6,
                 dcn_boundary_grad: str = "clip", dcn_impl_train: str = ""):
        super().__init__()
        out_ch = features * 4
        if downsample:
            self.shortcut_conv = Conv2d(cin, out_ch, 1, stride, dtype=dtype)
            self.shortcut_bn = make_norm(norm, out_ch, dtype)
        else:
            self.shortcut_conv = None
        self.conv1 = Conv2d(cin, features, 1, stride, dtype=dtype)
        self.bn1 = make_norm(norm, features, dtype)
        if with_dcn:
            self.conv2 = DeformConv(features, features, 3, use_bias=False, dtype=dtype,
                                    impl=dcn_impl, max_dy=dcn_max_dy,
                                    boundary_grad=dcn_boundary_grad,
                                    impl_train=dcn_impl_train)
        else:
            self.conv2 = Conv2d(features, features, 3, 1, dtype=dtype)
        self.bn2 = make_norm(norm, features, dtype)
        self.conv3 = Conv2d(features, out_ch, 1, 1, dtype=dtype)
        self.bn3 = make_norm(norm, out_ch, dtype)

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

    def __init__(self, depth: str = "resnet50", dtype=torch.float32,
                 norm: str = "frozen_bn", dcn_stages=(), dcn_impl: str = "auto",
                 dcn_max_dy: int = 6, dcn_boundary_grad: str = "clip",
                 dcn_impl_train: str = ""):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, 2, dtype=dtype)
        self.bn1 = make_norm(norm, 64, dtype)
        self.pool = nn.MaxPool2d(3, 2, 1)
        self.block_names = []
        cin = 64
        for stage_i, (n_blocks, width) in enumerate(
                zip(STAGE_BLOCKS[depth], (64, 128, 256, 512)), start=2):
            names = []
            for b in range(n_blocks):
                name = f"res{stage_i}_{b}"
                self.add_module(name, Bottleneck(
                    cin, width,
                    # res2 keeps stride 1 (its input is already at stride 4)
                    stride=2 if (b == 0 and stage_i > 2) else 1,
                    downsample=b == 0, dtype=dtype, norm=norm,
                    with_dcn=stage_i in dcn_stages, dcn_impl=dcn_impl,
                    dcn_max_dy=dcn_max_dy, dcn_boundary_grad=dcn_boundary_grad,
                    dcn_impl_train=dcn_impl_train))
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
