"""RPN proposal generation over the FPN pyramid ("PyramidProposal").

Port of ``upsnet_tpu/ops/proposals.py``, batched over images: per level,
2-way softmax objectness -> decode anchor deltas -> clip to the actual image
window -> drop empty boxes -> top-k; then concat levels -> cap -> joint
greedy NMS -> top-k. Static shapes: padded slots carry score -inf and a
False validity bit.

``lax.top_k`` breaks ties by lower index; ``top_k`` below does the same with
a stable sort.
"""

from __future__ import annotations

import torch

from upsnet_torch.ops.boxes import box_wh, clip_boxes, decode_boxes
from upsnet_torch.ops.nms import nms_padded


def top_k(x: torch.Tensor, k: int):
    """Descending top-k along the last axis, ties to the lower index."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _level_proposals(cls_logits, bbox_deltas, anchors, im_hw,
                     pre_nms_top_n: int, min_size: float):
    """cls_logits (B, H, W, A*2), bbox_deltas (B, H, W, A*4), anchors
    (H*W*A, 4), im_hw (B, 2) -> boxes (B, k, 4), scores (B, k)."""
    b = cls_logits.shape[0]
    logits = cls_logits.reshape(b, -1, 2).float()
    n = logits.shape[1]
    scores = torch.softmax(logits, dim=-1)[..., 1]
    deltas = bbox_deltas.reshape(b, n, 4).float()
    boxes = clip_boxes(decode_boxes(anchors[None], deltas), im_hw)
    bw, bh = box_wh(boxes)
    if min_size > 0:
        ok = (bw >= min_size + 1.0) & (bh >= min_size + 1.0)
    else:
        ok = (bw > 0) & (bh > 0)
    scores = torch.where(ok, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = top_k(scores, min(pre_nms_top_n, n))
    return _gather_rows(boxes, top_idx), top_scores


def pyramid_proposals(cls_logits, bbox_deltas, anchors, im_hw,
                      pre_nms_top_n: int = 1000, post_nms_top_n: int = 1000,
                      nms_thresh: float = 0.7, min_size: float = 0.0,
                      joint_nms_cap: int = 4096):
    """Batched proposal generation.

    cls_logits / bbox_deltas: per level (B, H, W, A*2) / (B, H, W, A*4),
    channel-last as the JAX package keeps them; anchors: per level
    (N_l, 4) tensors; im_hw (B, 2) actual image size in canvas pixels.
    Returns rois (B, post_nms_top_n, 4), scores (B, post_nms_top_n),
    valid (B, post_nms_top_n) bool.
    """
    all_boxes, all_scores = [], []
    for cl, bd, an in zip(cls_logits, bbox_deltas, anchors):
        bx, sc = _level_proposals(cl, bd, an, im_hw, pre_nms_top_n, min_size)
        all_boxes.append(bx)
        all_scores.append(sc)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    if joint_nms_cap and boxes.shape[1] > joint_nms_cap:
        scores, idx = top_k(scores, joint_nms_cap)
        boxes = _gather_rows(boxes, idx)
    valid = torch.isfinite(scores)
    idx, keep = nms_padded(boxes, scores, nms_thresh, post_nms_top_n, valid)
    safe = idx.clamp(min=0)
    rois = torch.where(keep[..., None], _gather_rows(boxes, safe), 0.0)
    roi_scores = torch.where(keep, torch.gather(scores, 1, safe),
                             float("-inf"))
    return rois, roi_scores, keep
