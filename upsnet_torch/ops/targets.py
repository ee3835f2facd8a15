"""Training-time target assignment, on the device, batched over images.

Port of ``upsnet_tpu/ops/targets.py``:

  * RPN anchor targets (Detectron rules): anchors straddling the image
    border are don't-care; fg = IoU >= 0.7 or per-GT argmax; bg = IoU < 0.3;
    sample ``rpn_batch_size`` anchors at <= 50% fg.
  * RoI targets for the box and mask heads: append the GT boxes to the
    proposals, fg = IoU >= 0.5, sample ``batch_rois`` at 25% fg; emit labels,
    bbox deltas (weights 10, 10, 5, 5), FPN levels and 28x28 mask targets
    cropped from the 1/4-scale GT masks.

Where the JAX functions ``vmap`` over images, these take a leading batch
axis. Random sampling is the same uniform-priority + top-k trick: among the
eligible candidates take the k with the highest random priority. The
priorities are the one place randomness enters, so each function takes them
as an optional tensor (a test hands both packages the same numbers); when
absent they are drawn from an explicit ``torch.Generator`` on the tensors'
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from upsnet_torch.ops.boxes import encode_boxes, fpn_level_assignment, pairwise_iou
from upsnet_torch.ops.proposals import _gather_rows, top_k
from upsnet_torch.ops.roi_align import _sample_coords


def crowd_overlap(boxes: torch.Tensor, crowd_boxes: torch.Tensor,
                  crowd_valid: torch.Tensor) -> torch.Tensor:
    """Max intersection-over-box-area of each box against the valid crowd
    regions. boxes (..., N, 4), crowd_boxes (..., Gc, 4), crowd_valid
    (..., Gc) -> (..., N)."""
    lt = torch.maximum(boxes[..., :, None, :2], crowd_boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], crowd_boxes[..., None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area = ((boxes[..., 2] - boxes[..., 0] + 1)
            * (boxes[..., 3] - boxes[..., 1] + 1)).clamp(min=1.0)
    ioa = inter / area[..., None]
    ioa = torch.where(crowd_valid[..., None, :], ioa, torch.zeros_like(ioa))
    if crowd_boxes.shape[-2] == 0:
        return torch.zeros(ioa.shape[:-1], dtype=ioa.dtype, device=ioa.device)
    return ioa.amax(dim=-1)


def _sample_k(pri: torch.Tensor, eligible: torch.Tensor, k: int):
    """Pick up to k True positions of ``eligible`` (B, n): those with the
    highest priority ``pri`` (B, n). Returns idx (B, k), valid (B, k)."""
    n = eligible.shape[-1]
    pri = torch.where(eligible, pri, torch.full_like(pri, -1.0))
    if k > n:  # fewer candidates than slots: pad with invalid entries
        pri = torch.nn.functional.pad(pri, (0, k - n), value=-1.0)
    top_pri, idx = top_k(pri, k)
    valid = top_pri >= 0  # eligible entries always outrank the -1 fill
    return idx.clamp(max=n - 1), valid


def _take_bg(bg_ok: torch.Tensor, n_fg: torch.Tensor, total: int) -> torch.Tensor:
    """Of the ranked background picks keep the first ``total - n_fg``."""
    bg_rank = torch.cumsum(bg_ok.to(torch.int32), dim=-1) - 1
    return bg_ok & (bg_rank < (total - n_fg)[..., None])


class RPNTargets(NamedTuple):
    labels: torch.Tensor  # (B, N) int32: 1 fg, 0 bg, -1 don't care
    bbox_targets: torch.Tensor  # (B, N, 4)
    bbox_inside: torch.Tensor  # (B, N) float: 1 for fg anchors
    norm: torch.Tensor  # (B,) count of sampled anchors per image


def rpn_targets(anchors, gt_boxes, gt_valid, im_hw, batch_size: int = 256,
                fg_fraction: float = 0.5, positive_overlap: float = 0.7,
                negative_overlap: float = 0.3, straddle_thresh: float = 0.0,
                crowd_boxes=None, crowd_valid=None, crowd_thresh: float = 0.7,
                pri_fg=None, pri_bg=None,
                generator: torch.Generator | None = None) -> RPNTargets:
    """anchors (N, 4) all levels concatenated; gt_boxes (B, G, 4) padded;
    gt_valid (B, G); im_hw (B, 2); pri_fg, pri_bg (B, N) sampling
    priorities (drawn from ``generator`` when None)."""
    b, n = gt_boxes.shape[0], anchors.shape[0]
    dev = anchors.device
    hh, ww = im_hw[:, 0:1], im_hw[:, 1:2]
    lo_ok = (anchors[:, 0] >= -straddle_thresh) & (anchors[:, 1] >= -straddle_thresh)
    inside = (lo_ok[None] & (anchors[None, :, 2] < ww + straddle_thresh)
              & (anchors[None, :, 3] < hh + straddle_thresh))  # (B, N)
    iou = pairwise_iou(anchors[None], gt_boxes)  # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    max_iou, argmax_gt = iou.max(dim=2)
    # per-GT best anchors also fg (ties included, Detectron behavior)
    gt_best = iou.amax(dim=1, keepdim=True)  # (B, 1, G)
    is_gt_argmax = ((iou == gt_best) & (gt_best > 0) & gt_valid[:, None, :]).any(dim=2)
    fg = inside & ((max_iou >= positive_overlap) | is_gt_argmax)
    bg = inside & (max_iou < negative_overlap) & ~fg
    if crowd_boxes is not None and crowd_boxes.shape[1]:
        in_crowd = crowd_overlap(anchors[None], crowd_boxes, crowd_valid) >= crowd_thresh
        fg = fg & ~in_crowd  # crowd regions are ignore, not supervision
        bg = bg & ~in_crowd

    if pri_fg is None:
        pri_fg = torch.rand((b, n), device=dev, generator=generator)
    if pri_bg is None:
        pri_bg = torch.rand((b, n), device=dev, generator=generator)
    k_fg = int(batch_size * fg_fraction)
    fg_idx, fg_ok = _sample_k(pri_fg, fg, k_fg)
    n_fg = fg_ok.sum(dim=1)
    bg_idx, bg_ok = _sample_k(pri_bg, bg, batch_size)  # oversample, trim below
    bg_take = _take_bg(bg_ok, n_fg, batch_size)

    # scatter only the taken samples: padded top-k slots hold indices of
    # arbitrary anchors, so untaken writes go to an extra column n that is
    # cut off afterwards
    labels = torch.full((b, n + 1), -1, dtype=torch.int32, device=dev)
    spill = torch.full_like(bg_idx, n)
    labels.scatter_(1, torch.where(bg_take, bg_idx, spill), 0)
    labels.scatter_(1, torch.where(fg_ok, fg_idx, spill[:, :k_fg]), 1)
    labels = labels[:, :n]

    matched = _gather_rows(gt_boxes, argmax_gt)
    bbox_targets = encode_boxes(anchors[None], matched)
    bbox_inside = (labels == 1).float()
    norm = (labels >= 0).sum(dim=1).float().clamp(min=1.0)
    return RPNTargets(labels, bbox_targets, bbox_inside, norm)


class RoITargets(NamedTuple):
    rois: torch.Tensor  # (B, R, 4)
    valid: torch.Tensor  # (B, R) bool
    labels: torch.Tensor  # (B, R) int32 class (0 = background)
    bbox_targets: torch.Tensor  # (B, R, 4) deltas to matched GT
    fg: torch.Tensor  # (B, R) bool
    levels: torch.Tensor  # (B, R) int32 FPN level index (0 -> P2)
    mask_targets: torch.Tensor  # (B, R, M, M) float in {0, 1}
    matched_gt: torch.Tensor  # (B, R) int32 index of matched GT


def _axis_hat(coords: torch.Tensor, size: int) -> torch.Tensor:
    """Dense per-axis bilinear weights with the Detectron clamp: coords
    (N, PS) -> (N, PS, size), ``1[-1 <= c <= size] * max(0, 1 - |clip(c, 0,
    size - 1) - y|)``."""
    inside = (coords >= -1.0) & (coords <= float(size))
    c = coords.clamp(0.0, float(size - 1))
    grid = torch.arange(size, dtype=coords.dtype, device=coords.device)
    k = (1.0 - (c[..., None] - grid).abs()).clamp(min=0.0)
    return k * inside[..., None]


def proposal_mask_targets(proposals, proposal_valid, gt_boxes, gt_classes, gt_valid,
                          gt_masks, batch_rois: int = 512, fg_fraction: float = 0.25,
                          fg_thresh: float = 0.5, bg_thresh_hi: float = 0.5,
                          bg_thresh_lo: float = 0.0,
                          bbox_weights=(10.0, 10.0, 5.0, 5.0), mask_size: int = 28,
                          mask_scale: float = 1.0, crowd_boxes=None, crowd_valid=None,
                          crowd_thresh: float = 0.7, pri_fg=None, pri_bg=None,
                          generator: torch.Generator | None = None) -> RoITargets:
    """proposals (B, P, 4), proposal_valid (B, P); gt_boxes (B, G, 4),
    gt_classes (B, G) in 1..num_classes-1, gt_valid (B, G); gt_masks
    (B, G, Hm, Wm) rasterised at ``mask_scale`` of image coordinates;
    pri_fg, pri_bg (B, P + G) sampling priorities (drawn from ``generator``
    when None). The first ``batch_rois * fg_fraction`` slots hold the fg
    samples, the rest the bg samples."""
    b = proposals.shape[0]
    dev = proposals.device
    # Detectron appends GT boxes to the proposal set.
    cand = torch.cat([proposals, gt_boxes], dim=1)
    cand_valid = torch.cat([proposal_valid, gt_valid], dim=1)
    n = cand.shape[1]
    iou = pairwise_iou(cand, gt_boxes)
    iou = torch.where(gt_valid[:, None, :] & cand_valid[:, :, None], iou,
                      torch.zeros_like(iou))
    max_iou, argmax_gt = iou.max(dim=2)

    fg = cand_valid & (max_iou >= fg_thresh)
    bg = cand_valid & (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo)
    if crowd_boxes is not None and crowd_boxes.shape[1]:
        # proposals mostly covered by a crowd region leave the negative
        # pool; a confident fg match to a real GT still trains
        in_crowd = (crowd_overlap(cand, crowd_boxes, crowd_valid) >= crowd_thresh) & ~fg
        bg = bg & ~in_crowd

    if pri_fg is None:
        pri_fg = torch.rand((b, n), device=dev, generator=generator)
    if pri_bg is None:
        pri_bg = torch.rand((b, n), device=dev, generator=generator)
    k_fg = int(batch_rois * fg_fraction)
    k_bg = batch_rois - k_fg
    fg_idx, fg_ok = _sample_k(pri_fg, fg, k_fg)
    n_fg = fg_ok.sum(dim=1)
    bg_idx, bg_ok = _sample_k(pri_bg, bg, batch_rois)
    bg_take = _take_bg(bg_ok, n_fg, batch_rois)

    sel_idx = torch.cat([fg_idx, bg_idx[:, :k_bg]], dim=1)
    sel_fg = torch.cat([fg_ok, torch.zeros((b, k_bg), dtype=torch.bool, device=dev)], 1)
    sel_ok = torch.cat([fg_ok, bg_take[:, :k_bg]], dim=1)

    rois = _gather_rows(cand, sel_idx)
    m_gt = torch.gather(argmax_gt, 1, sel_idx)
    labels = torch.where(sel_fg & sel_ok, torch.gather(gt_classes.long(), 1, m_gt),
                         torch.zeros_like(m_gt)).to(torch.int32)
    bbox_targets = encode_boxes(rois, _gather_rows(gt_boxes, m_gt), bbox_weights)
    levels = fpn_level_assignment(rois) - 2

    # Mask targets: bilinear crop of the matched GT mask inside each fg RoI
    # to mask_size^2 (2x2 samples per bin, averaged), binarised at 0.5, as
    # dense separable-hat matmuls Ky @ M @ Kx^T like the JAX function.
    hm, wm = gt_masks.shape[-2:]
    s = 2
    ps = mask_size * s
    fg_gt = m_gt[:, :k_fg]
    rows = torch.arange(b, device=dev)[:, None]
    fg_masks = gt_masks[rows, fg_gt].float().reshape(b * k_fg, hm, wm)
    y, x = _sample_coords(rois[:, :k_fg].reshape(b * k_fg, 4) * mask_scale, 1.0,
                          mask_size, s)
    sy = y[:, :, 0, :, 0].reshape(b * k_fg, ps)
    sx = x[:, 0, :, 0, :].reshape(b * k_fg, ps)
    ky = _axis_hat(sy, hm)  # (N, PS, Hm)
    kx = _axis_hat(sx, wm)  # (N, PS, Wm)
    crops = torch.matmul(torch.matmul(ky, fg_masks), kx.transpose(1, 2))
    crops = crops.reshape(b, k_fg, mask_size, s, mask_size, s).mean(dim=(3, 5))
    mask_targets = torch.cat([
        (crops >= 0.5).float(),
        torch.zeros((b, k_bg, mask_size, mask_size), device=dev)], dim=1)

    return RoITargets(rois=rois, valid=sel_ok, labels=labels, bbox_targets=bbox_targets,
                      fg=sel_fg & sel_ok, levels=levels.to(torch.int32),
                      mask_targets=mask_targets, matched_gt=m_gt.to(torch.int32))
