"""Semantic segmentation (FCN) head with deformable convolutions.

Port of ``upsnet_tpu/models/fcn.py``: P2..P5 each pass through one shared
subnet of stacked 3x3 deformable convs; every level is bilinearly upsampled
to P2's resolution, concatenated, and a 1x1 conv gives the semantic logits
(stuff channels first). NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from upsnet_torch.models.layers import Conv2d, DeformConv


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) bilinear resize with half-pixel centers, the
    ``jax.image.resize(method='bilinear')`` the JAX head upsamples with."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


class FCNSubNet(nn.Module):
    def __init__(self, in_channels: int, channels: int = 128,
                 num_layers: int = 2, with_dcn: bool = True,
                 dcn_impl: str = "auto", dcn_max_dy: int = 6,
                 dtype=torch.float32, dcn_boundary_grad: str = "clip",
                 dcn_impl_train: str = ""):
        super().__init__()
        self.layer_names = []
        cin = in_channels
        for i in range(num_layers):
            if with_dcn:
                name = f"dcn{i + 1}"
                layer = DeformConv(cin, channels, 3, dtype=dtype, impl=dcn_impl,
                                   max_dy=dcn_max_dy,
                                   boundary_grad=dcn_boundary_grad,
                                   impl_train=dcn_impl_train)
            else:
                name = f"conv{i + 1}"
                layer = Conv2d(cin, channels, 3, bias=True, dtype=dtype)
            self.add_module(name, layer)
            self.layer_names.append(name)
            cin = channels

    def forward(self, x):
        for name in self.layer_names:
            x = torch.relu(getattr(self, name)(x))
        return x


class FCNHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256,
                 channels: int = 128, num_layers: int = 2,
                 with_dcn: bool = True, shared_subnet: bool = True,
                 dcn_impl: str = "auto", dcn_max_dy: int = 6,
                 dtype=torch.float32, dcn_boundary_grad: str = "clip",
                 dcn_impl_train: str = ""):
        super().__init__()

        def subnet():
            return FCNSubNet(in_channels, channels, num_layers, with_dcn,
                             dcn_impl, dcn_max_dy, dtype, dcn_boundary_grad,
                             dcn_impl_train)

        self.shared_subnet = shared_subnet
        if shared_subnet:
            self.subnet = subnet()
        else:
            for i in range(2, 6):
                self.add_module(f"subnet{i}", subnet())
        self.score = Conv2d(4 * channels, num_classes, 1, bias=True, dtype=dtype)

    def forward(self, pyramid):  # (P2, P3, P4, P5)
        out_hw = pyramid[0].shape[2:]
        feats = []
        for i, p in enumerate(pyramid, start=2):
            net = self.subnet if self.shared_subnet else getattr(self, f"subnet{i}")
            f = net(p)
            if f.shape[2:] != out_hw:
                f = resize_bilinear(f, out_hw)
            feats.append(f)
        x = torch.cat(feats, dim=1)
        # (B, num_seg_classes, H/4, W/4) and the fused 1/4-scale feature
        return self.score(x), x
