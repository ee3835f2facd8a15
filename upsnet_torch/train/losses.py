"""The 7-term UPSNet loss stack.

  rpn_cls + rpn_bbox + cls + bbox + mask + w_seg * (seg [+ seg_roi]) +
  w_pano * pano

Port of ``upsnet_tpu/train/losses.py``, Detectron-lineage conventions:
2-way softmax RPN objectness; smooth-L1 with beta = 1/9 for RPN bbox and
beta = 1 for RCNN bbox; per-pixel sigmoid BCE on the GT-class mask channel;
softmax CE with ignore label 255 for the semantic and panoptic heads. Every
function takes explicit validity masks, normalises by the sampled count as
the reference does, and computes log-softmax and sums in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1(pred, target, beta: float):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def softmax_ce(logits, labels, valid, dims=None):
    """Softmax cross-entropy over the last axis, averaged over the valid
    entries: of everything (``dims`` None, a scalar) or of the axes ``dims``
    only. labels integer, logits (..., C), valid bool like labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    ll = torch.where(valid, ll, torch.zeros_like(ll))
    if dims is None:
        return -ll.sum() / valid.sum().float().clamp(min=1.0)
    return -ll.sum(dim=dims) / valid.sum(dim=dims).float().clamp(min=1.0)


def rpn_cls_loss(cls_logits_flat, labels):
    """cls_logits_flat (N, 2); labels (N,) in {1 fg, 0 bg, -1 ignore}."""
    return softmax_ce(cls_logits_flat, labels.clamp(min=0), labels >= 0)


def rpn_bbox_loss(bbox_pred_flat, targets, fg_mask, norm, beta: float = 1.0 / 9.0):
    loss = smooth_l1(bbox_pred_flat.float(), targets, beta)
    return (loss * fg_mask[:, None]).sum() / norm.clamp(min=1.0)


def rcnn_cls_loss(cls_score, labels, valid):
    return softmax_ce(cls_score, labels, valid)


def rcnn_bbox_loss(bbox_pred, labels, bbox_targets, fg, valid, beta: float = 1.0):
    """Class-specific regression on the 4 deltas of the GT class. bbox_pred
    (R, 4*C); labels (R,); bbox_targets (R, 4); fg, valid (R,) bool.
    Normalised by the number of valid sampled RoIs."""
    r = bbox_pred.shape[0]
    pred = bbox_pred.reshape(r, -1, 4).float()
    sel = pred[torch.arange(r, device=pred.device), labels.long()]
    loss = smooth_l1(sel, bbox_targets, beta).sum(-1)
    loss = torch.where(fg, loss, torch.zeros_like(loss))
    return loss.sum() / valid.sum().float().clamp(min=1.0)


def mask_loss(mask_logits, labels, mask_targets, fg):
    """Per-pixel BCE on the GT-class channel of fg RoIs. mask_logits
    (R, C, M, M) as the mask head writes them; labels (R,); mask_targets
    (R, M, M) in {0, 1}; fg (R,) bool."""
    r = mask_logits.shape[0]
    sel = mask_logits.float()[torch.arange(r, device=mask_logits.device), labels.long()]
    bce = sel.clamp(min=0) - sel * mask_targets + torch.log1p(torch.exp(-sel.abs()))
    bce = bce.mean(dim=(1, 2))
    return torch.where(fg, bce, torch.zeros_like(bce)).sum() / fg.sum().float().clamp(min=1.0)


def seg_loss(seg_logits, seg_gt, ignore: int = 255):
    """Semantic CE at 1/4 scale. seg_logits (B, H, W, C); seg_gt (B, H, W)
    with 255 = ignore."""
    valid = seg_gt != ignore
    return softmax_ce(seg_logits, torch.where(valid, seg_gt, torch.zeros_like(seg_gt)),
                      valid)


def seg_roi_loss(seg_logits, seg_gt, gt_boxes_seg, gt_valid, crop: int = 28,
                 ignore: int = 255):
    """RoI re-weighted semantic loss: crop logits and GT inside each GT box,
    resize to crop^2 with nearest sampling, CE over the crops of an image.
    seg_logits (B, H, W, C); seg_gt (B, H, W); gt_boxes_seg (B, G, 4) at seg
    scale; gt_valid (B, G). Returns the per-image losses (B,)."""
    b, h, w, _ = seg_logits.shape
    m = crop
    x1, y1, x2, y2 = (gt_boxes_seg[..., i:i + 1] for i in range(4))  # (B, G, 1)
    bw = (x2 - x1 + 1.0).clamp(min=1.0)
    bh = (y2 - y1 + 1.0).clamp(min=1.0)
    steps = (torch.arange(m, dtype=torch.float32, device=seg_logits.device) + 0.5) / m
    ys = y1 + steps * bh - 0.5  # (B, G, m)
    xs = x1 + steps * bw - 0.5
    yi = torch.round(ys).clamp(0, h - 1).long()[:, :, :, None]
    xi = torch.round(xs).clamp(0, w - 1).long()[:, :, None, :]
    img = torch.arange(b, device=seg_logits.device)[:, None, None, None]
    flat = ((img * h + yi) * w + xi).reshape(-1)  # pixels of the (B*H*W, C) map
    # index_select, not advanced indexing: its backward is an atomic
    # index_add_, where indexing's sorts all B*G*m*m indices first
    lgs = seg_logits.reshape(b * h * w, -1).index_select(0, flat)
    lgs = lgs.reshape(b, -1, m, m, seg_logits.shape[-1])  # (B, G, m, m, C)
    gts = seg_gt.reshape(-1)[flat].reshape(b, -1, m, m)
    valid = (gts != ignore) & gt_valid[:, :, None, None]
    return softmax_ce(lgs, torch.where(valid, gts, torch.zeros_like(gts)), valid,
                      dims=(1, 2, 3))


def panoptic_loss(pan_logits, pan_gt, ignore: int = 255):
    """CE over the (S + G + 1)-channel panoptic stack. pan_logits (K, H, W);
    pan_gt (H, W) int with 255 ignore."""
    valid = pan_gt != ignore
    return softmax_ce(pan_logits.permute(1, 2, 0),
                      torch.where(valid, pan_gt, torch.zeros_like(pan_gt)), valid)
