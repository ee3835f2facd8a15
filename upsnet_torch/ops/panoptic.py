"""Panoptic head ops: SegTerm, MaskTerm, MaskRemoval, the streaming argmax
of inference, and the logit stack and MaskMatching GT of training.

Port of ``upsnet_tpu/ops/panoptic.py``. Panoptic
logits over (S stuff + N instances + 1 unknown) channels at 1/4 scale:
  Z[j]      = X_stuff_j
  Z[S + i]  = SegTerm_i + MaskTerm_i
  Z[S + N]  = max_c X_thing_c - max_i SegTerm_i
The per-pixel argmax breaks ties first-wins in that order: stuff, then
instances, then unknown. Single image, as the JAX functions (the batch is a
loop in ``models.upsnet``).
"""

from __future__ import annotations

import torch

from upsnet_torch.ops.mask_paste import paste_masks

IGNORE = 255


def _box_window(boxes: torch.Tensor, hw, dtype, row0: int = 0) -> torch.Tensor:
    """(N, H, W) indicator of each box's pixel window (inclusive coords), on
    the canvas rows ``row0 .. row0 + H - 1``."""
    h, w = hw
    ys = torch.arange(row0, row0 + h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    xs = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :]
    x1, y1, x2, y2 = (boxes[:, i][:, None, None] for i in range(4))
    win = ((ys >= torch.floor(y1)) & (ys <= torch.ceil(y2))
           & (xs >= torch.floor(x1)) & (xs <= torch.ceil(x2)))
    return win.to(dtype)


def seg_term(seg_logits: torch.Tensor, boxes: torch.Tensor,
             classes: torch.Tensor, num_stuff: int, row0: int = 0) -> torch.Tensor:
    """seg_logits (H, W, C) stuff first, canvas rows from ``row0``; boxes
    (N, 4) at seg scale; classes (N,) thing index. Each instance's thing
    channel inside its box, 0 outside: (N, H, W)."""
    h, w, _ = seg_logits.shape
    chan = seg_logits[:, :, num_stuff:].permute(2, 0, 1)[classes.long()]
    return chan * _box_window(boxes, (h, w), chan.dtype, row0)


def mask_term(mask_logits: torch.Tensor, boxes: torch.Tensor,
              out_hw, row0: int = 0) -> torch.Tensor:
    """Per-instance mask logits pasted into canvases (0 outside)."""
    return paste_masks(mask_logits, boxes, out_hw, row0=row0)


def panoptic_logits(seg_logits, boxes, classes, mask_logits, inst_valid,
                    num_stuff: int) -> torch.Tensor:
    """The (S + N + 1, H, W) panoptic logit stack the training loss needs,
    differentiable in seg_logits and mask_logits. seg_logits (H, W, C);
    boxes (N, 4) at seg scale; classes (N,) thing index; mask_logits
    (N, M, M); inst_valid (N,) bool (invalid instances sit at -1e4)."""
    h, w, _ = seg_logits.shape
    stuff = seg_logits[:, :, :num_stuff].permute(2, 0, 1)
    seg_t = seg_term(seg_logits, boxes, classes, num_stuff)
    inst = seg_t + mask_term(mask_logits, boxes, (h, w))
    neg = torch.tensor(-1e4, dtype=inst.dtype, device=inst.device)
    valid = inst_valid[:, None, None]
    inst = torch.where(valid, inst, neg)
    thing_max = seg_logits[:, :, num_stuff:].amax(-1)
    inst_max = torch.where(valid, seg_t, neg).amax(0)
    inst_max = torch.where(inst_valid.any(), inst_max, torch.zeros_like(inst_max))
    unknown = (thing_max - inst_max)[None]
    return torch.cat([stuff, inst, unknown], dim=0)


def panoptic_argmax(seg_logits, boxes, classes, mask_logits, inst_valid,
                    num_stuff: int):
    """Per-pixel argmax over the stack (ties to the first channel) and the
    stack itself: (pan_id (H, W) int32, logits (S + N + 1, H, W))."""
    logits = panoptic_logits(seg_logits, boxes, classes, mask_logits, inst_valid,
                             num_stuff)
    return logits.argmax(dim=0).to(torch.int32), logits


def mask_matching(seg_gt, gt_masks, gt_valid, to_unknown, num_stuff: int,
                  ignore: int = IGNORE) -> torch.Tensor:
    """The panoptic head's GT index map. seg_gt (H, W) int semantic GT
    (stuff first, 255 ignore); gt_masks (G, H, W); gt_valid, to_unknown
    (G,) bool. Stuff pixels keep their channel; pixels of GT instance i get
    ``num_stuff + i``, or the unknown channel ``num_stuff + G`` when the
    instance is flagged ``to_unknown``; later instances overwrite earlier
    ones; thing pixels under no instance are ignore. Returns (H, W) int32."""
    g = gt_masks.shape[0]
    dev = seg_gt.device
    is_stuff = (seg_gt < num_stuff) & (seg_gt != ignore)
    out = torch.where(is_stuff, seg_gt, torch.full_like(seg_gt, ignore)).to(torch.int32)
    ids = torch.arange(g, device=dev)
    chan = torch.where(to_unknown, torch.full_like(ids, num_stuff + g), num_stuff + ids)
    chan = torch.where(gt_valid, chan, torch.full_like(ids, ignore)).to(torch.int32)
    # the last covering instance wins, as the reference's sequential overwrite
    cover = (gt_masks > 0) & (chan != ignore)[:, None, None]
    last = torch.where(cover, ids[:, None, None], torch.full_like(ids, -1)[:, None, None]
                       ).amax(dim=0)
    return torch.where(last >= 0, chan[last.clamp(min=0)], out)


def panoptic_argmax_stream(seg_logits, boxes, classes, mask_logits,
                           inst_valid, num_stuff: int, row0: int = 0) -> torch.Tensor:
    """Per-pixel argmax over the panoptic stack without materialising it:
    (max, argmax) per channel group combined with the first-wins order.
    seg_logits may be the row slab from canvas row ``row0``. Returns (H, W)
    int32 channel indices."""
    h, w, _ = seg_logits.shape
    n = mask_logits.shape[0]
    stuff_max, stuff_arg = seg_logits[:, :, :num_stuff].max(-1)

    seg_t = seg_term(seg_logits, boxes, classes, num_stuff, row0)
    inst = seg_t + mask_term(mask_logits, boxes, (h, w), row0)
    neg = torch.tensor(-1e4, dtype=inst.dtype, device=inst.device)
    valid = inst_valid[:, None, None]
    inst = torch.where(valid, inst, neg)
    inst_max, inst_arg = inst.max(0)

    thing_max = seg_logits[:, :, num_stuff:].amax(-1)
    segt_max = torch.where(valid, seg_t, neg).amax(0)
    segt_max = torch.where(inst_valid.any(), segt_max, torch.zeros_like(segt_max))
    unknown = thing_max - segt_max

    stuff_wins = (stuff_max >= inst_max) & (stuff_max >= unknown)
    inst_wins = inst_max >= unknown
    pan = torch.where(stuff_wins, stuff_arg,
                      torch.where(inst_wins, num_stuff + inst_arg,
                                  torch.full_like(inst_arg, num_stuff + n)))
    return pan.to(torch.int32)


def mask_removal(masks: torch.Tensor, valid: torch.Tensor,
                 overlap_keep_thresh: float = 0.5) -> torch.Tensor:
    """Greedy de-overlap: walk the (score-sorted) masks in order, keep one
    iff the fraction of its mask not yet claimed is >= the threshold; kept
    masks claim their pixels. masks (..., N, H, W), valid (..., N), any
    leading batch dims. Returns (..., N) bool. The scan stays on the
    device: one step per detection, all images at once."""
    bin_masks = masks >= 0.5
    claimed = torch.zeros_like(bin_masks[..., 0, :, :])
    keep = []
    for i in range(masks.shape[-3]):
        m, ok = bin_masks[..., i, :, :], valid[..., i]
        area = m.sum(dim=(-2, -1)).float()
        fresh = (m & ~claimed).sum(dim=(-2, -1)).float()
        k = ok & (area > 0) & (fresh / area.clamp(min=1.0) >= overlap_keep_thresh)
        claimed = claimed | (m & k[..., None, None])
        keep.append(k)
    return torch.stack(keep, dim=-1)
