"""RCNN box head and mask head (port of ``upsnet_tpu/models/heads.py``).

Both consume pooled features channel-last, (R, P, P, C), as the ROIAlign
kernel writes them. The box head flattens in that (P, P, C) order — the
JAX fc1 layout — so its weight needs only the Dense transpose. The mask head
runs its convs NCHW: 4x conv3x3 -> 2x deconv -> 1x1 -> (R, ncls, 28, 28).
"""

from __future__ import annotations

import torch
from torch import nn

from upsnet_torch.models.layers import Conv2d, ConvTranspose2d, Linear


class BoxHead(nn.Module):
    def __init__(self, num_classes: int, in_features: int, fc_dim: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(in_features, fc_dim, dtype)
        self.fc2 = Linear(fc_dim, fc_dim, dtype)
        self.cls_score = Linear(fc_dim, num_classes, dtype, init_std=0.01)
        self.bbox_pred = Linear(fc_dim, num_classes * 4, dtype, init_std=0.001)

    def forward(self, pooled):  # (R, P, P, C)
        x = pooled.reshape(pooled.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256,
                 channels: int = 256, num_convs: int = 4, dtype=torch.float32):
        super().__init__()
        self.num_convs = num_convs
        cin = in_channels
        for i in range(num_convs):
            self.add_module(f"conv{i + 1}", Conv2d(cin, channels, 3, bias=True,
                                                   dtype=dtype))
            cin = channels
        self.deconv = ConvTranspose2d(channels, channels, 2, dtype)
        self.mask_score = Conv2d(channels, num_classes, 1, bias=True, dtype=dtype)

    def forward(self, pooled):  # (R, 14, 14, C) -> (R, num_classes, 28, 28)
        x = pooled.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x))
        return self.mask_score(torch.relu(self.deconv(x)))
