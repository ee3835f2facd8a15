"""Feature Pyramid Network neck (port of ``upsnet_tpu/models/fpn.py``).

1x1 laterals on C2..C5, top-down nearest 2x upsample + add, 3x3 output
convs -> P2..P5; P6 = stride-2 subsample of P5 (RPN only). NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from upsnet_torch.models.layers import Conv2d


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), nearest neighbour."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048),
                 out_channels: int = 256, dtype=torch.float32):
        super().__init__()
        for i, cin in enumerate(in_channels, start=2):
            self.add_module(f"lateral{i}", Conv2d(cin, out_channels, 1, bias=True,
                                                  dtype=dtype))
            self.add_module(f"output{i}", Conv2d(out_channels, out_channels, 3,
                                                 bias=True, dtype=dtype))

    def forward(self, feats):  # (C2, C3, C4, C5)
        lat = [getattr(self, f"lateral{i}")(c) for i, c in enumerate(feats, start=2)]
        tops = [lat[3]]
        for i in (2, 1, 0):
            tops.insert(0, lat[i] + upsample2x_nearest(tops[0]))
        ps = [getattr(self, f"output{i}")(t) for i, t in enumerate(tops, start=2)]
        p6 = ps[3][:, :, ::2, ::2]
        return tuple(ps) + (p6,)  # P2..P6
