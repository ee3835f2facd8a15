"""Box utilities: IoU, encode, decode, clip, FPN level assignment.

Port of ``upsnet_tpu/ops/boxes.py``. Boxes are ``(x1, y1, x2, y2)`` with the
Detectron **legacy +1 convention** (``width = x2 - x1 + 1``), which the
released UPSNet checkpoints were trained with. Every function broadcasts
over leading batch dimensions.
"""

from __future__ import annotations

import torch

# Detectron clamps dw/dh before exp to avoid overflow: log(1000/16), as f32.
BBOX_XFORM_CLIP = float(torch.tensor(1000.0 / 16.0).log())


def box_wh(boxes: torch.Tensor, offset: float = 1.0):
    w = boxes[..., 2] - boxes[..., 0] + offset
    h = boxes[..., 3] - boxes[..., 1] + offset
    return w, h


def box_area(boxes: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
    w, h = box_wh(boxes, offset)
    return w.clamp(min=0.0) * h.clamp(min=0.0)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor,
                 offset: float = 1.0) -> torch.Tensor:
    """IoU matrix (..., N, M) for boxes1 (..., N, 4), boxes2 (..., M, 4)."""
    a1 = box_area(boxes1, offset)[..., :, None]
    a2 = box_area(boxes2, offset)[..., None, :]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + offset).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1 + a2 - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def encode_boxes(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0), offset: float = 1.0) -> torch.Tensor:
    """Box regression targets (dx, dy, dw, dh) from ``boxes`` to ``gt_boxes``."""
    w, h = box_wh(boxes, offset)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    gw, gh = box_wh(gt_boxes, offset)
    gcx = gt_boxes[..., 0] + 0.5 * gw
    gcy = gt_boxes[..., 1] + 0.5 * gh
    wx, wy, ww, wh_ = weights
    w = w.clamp(min=1e-6)
    h = h.clamp(min=1e-6)
    dx = wx * (gcx - cx) / w
    dy = wy * (gcy - cy) / h
    dw = ww * torch.log(gw.clamp(min=1e-6) / w)
    dh = wh_ * torch.log(gh.clamp(min=1e-6) / h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(boxes: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 offset: float = 1.0) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas (..., N, 4) to boxes."""
    w, h = box_wh(boxes, offset)
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh_ = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh_).clamp(max=BBOX_XFORM_CLIP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    # Detectron: x2 = cx + 0.5*w - 1 under the +1 convention.
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph,
         pcx + 0.5 * pw - offset, pcy + 0.5 * ph - offset],
        dim=-1,
    )


def clip_boxes(boxes: torch.Tensor, im_hw: torch.Tensor,
               offset: float = 1.0) -> torch.Tensor:
    """Clip to [0, W-1] x [0, H-1]. im_hw (..., 2) broadcasts against the
    boxes' leading dims with one trailing box axis added."""
    hmax = (im_hw[..., 0] - offset)[..., None]
    wmax = (im_hw[..., 1] - offset)[..., None]
    while hmax.dim() < boxes.dim() - 1:
        hmax, wmax = hmax[..., None], wmax[..., None]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), wmax)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), hmax)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), wmax)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), hmax)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def fpn_level_assignment(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5,
                         canonical_scale: float = 224.0,
                         canonical_level: int = 4,
                         offset: float = 1.0) -> torch.Tensor:
    """FPN RoI-to-level: k = floor(k0 + log2(sqrt(wh)/224)), clamped."""
    w, h = box_wh(boxes, offset)
    s = torch.sqrt((w * h).clamp(min=1e-6))
    k = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-12))
    return k.clamp(k_min, k_max).to(torch.int32)

