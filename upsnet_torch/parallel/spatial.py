"""Row-slab panoptic fusion across ranks, the port of
``upsnet_tpu/parallel/spatial.py``.

Each rank holds a slab of rows of the 1/4-scale semantic logits and fuses
only that slab: it pastes each detection's mask into its rows, runs the
streaming argmax on them, and writes its rows of the panoptic map.
Everything in the fusion is row-local except MaskRemoval's keep decision,
which reads each mask's area over the whole image: the areas are an
``all_reduce`` sum over the group. A mask's ``area`` does not depend on what
earlier masks claimed, so one reduction before the loop serves every step,
and ``fresh`` (the unclaimed part) takes one reduction a step. Both are
integer counts, so the sums have the bits of the single-device ones.

Rows are computed in canvas coordinates (``row0`` in ``ops/mask_paste.py``
and ``ops/panoptic.py``), not by shifting the boxes into the slab, so each
pasted row has the bits of the same row pasted by ``panoptic_fuse``; the
panoptic map and the keep flags equal ``models.upsnet.panoptic_fuse``'s.
"""

from __future__ import annotations

import torch

from upsnet_torch.ops import panoptic as pan_ops
from upsnet_torch.parallel.mesh import Group


def spatial_panoptic_fuse(group: Group, seg_slab: torch.Tensor, boxes: torch.Tensor,
                          classes: torch.Tensor, mask_logits: torch.Tensor,
                          scores: torch.Tensor, valid: torch.Tensor, *,
                          score_thresh: float, overlap_thresh: float, num_stuff: int):
    """Fuse one image whose semantic logits (H, W, C) are split by rows over
    ``group``: this rank holds ``seg_slab`` (H / world, W, C), rows
    ``rank * H / world`` on. boxes (D, 4) in image coordinates; classes,
    scores, valid (D,); mask_logits (D, M, M); the same on every rank.
    Returns (this rank's rows of pan_map (H / world, W) int32, keep (D,)
    bool, equal on every rank)."""
    seg_slab = seg_slab.float()
    hs, w = seg_slab.shape[:2]
    row0 = group.rank * hs
    boxes_q = boxes * 0.25
    keep_score = valid & (scores >= score_thresh)
    pasted = pan_ops.mask_term(torch.sigmoid(mask_logits), boxes_q, (hs, w), row0)
    bin_masks = pasted >= 0.5
    area = group.all_reduce_sum(bin_masks.sum(dim=(-2, -1)).float())
    claimed = torch.zeros_like(bin_masks[0])
    keep = []
    for i in range(bin_masks.shape[0]):
        m = bin_masks[i]
        fresh = group.all_reduce_sum((m & ~claimed).sum().float())
        k = keep_score[i] & (area[i] > 0) & (fresh / area[i].clamp(min=1.0) >= overlap_thresh)
        claimed = claimed | (m & k)
        keep.append(k)
    keep = torch.stack(keep)
    pan_map = pan_ops.panoptic_argmax_stream(
        seg_slab, boxes_q, (classes - 1).clamp(min=0), mask_logits, keep, num_stuff, row0)
    return pan_map, keep
