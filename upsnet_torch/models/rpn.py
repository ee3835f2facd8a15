"""Region Proposal Network head, shared across FPN levels.

Port of ``upsnet_tpu/models/rpn.py``: 3x3 conv + ReLU -> 1x1 objectness
(A x (bg, fg)) and 1x1 deltas (A x 4). The convs compute NCHW; outputs are
returned channel-last, (B, H, W, A*2) and (B, H, W, A*4), so that flattening
reads the per-anchor (bg, fg) pairs in the (y, x, a) order of the anchors.
"""

from __future__ import annotations

import torch
from torch import nn

from upsnet_torch.models.layers import Conv2d


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 3, channels: int = 256,
                 in_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, bias=True, dtype=dtype)
        self.cls_score = Conv2d(channels, num_anchors * 2, 1, bias=True, dtype=dtype)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1, bias=True, dtype=dtype)

    def forward(self, pyramid):
        cls_out, bbox_out = [], []
        for p in pyramid:
            h = torch.relu(self.conv(p))
            cls_out.append(self.cls_score(h).permute(0, 2, 3, 1))
            bbox_out.append(self.bbox_pred(h).permute(0, 2, 3, 1))
        return cls_out, bbox_out
