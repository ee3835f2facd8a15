"""Greedy NMS over padded box sets, batched over leading dimensions.

Port of ``upsnet_tpu/ops/nms.py``: sort by score (stable, so ties keep input
order as ``jnp.argsort`` does), build the "i suppresses j" matrix for i < j
with IoU > thresh, and iterate ``keep[j] = not any_i(keep[i] & sup[i, j])``
to its fixpoint, which is exactly greedy NMS. The JAX ``lax.while_loop``
becomes a Python loop that reads one flag from the device per iteration
(a ``nms_fixpoint`` host sync, ``utils/profiling.py``, so that site's count
is the number of iterations); every image of the batch iterates together
until none changes.
"""

from __future__ import annotations

import torch

from upsnet_torch.ops.boxes import pairwise_iou
from upsnet_torch.utils.profiling import host_sync


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               max_out: int, valid: torch.Tensor | None = None,
               offset: float = 1.0):
    """Greedy NMS.

    boxes (..., N, 4), scores (..., N), valid optional (..., N) bool.
    Returns (indices (..., max_out) int64 padded with -1 and ordered by
    descending score, keep_valid (..., max_out) bool).
    """
    n = boxes.shape[-2]
    with host_sync("const_h2d"):
        neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                               device=scores.device)
    if valid is not None:
        scores = torch.where(valid, scores, neg_inf)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    sscores = torch.gather(scores, -1, order)
    svalid = sscores > neg_inf

    iou = pairwise_iou(sboxes, sboxes, offset=offset)
    upper = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou > iou_thresh) & upper
    sup = sup & svalid[..., :, None] & svalid[..., None, :]

    def body(keep):
        return ~torch.any(keep[..., :, None] & sup, dim=-2) & svalid

    keep = body(svalid)
    while True:
        nxt = body(keep)
        with host_sync("nms_fixpoint"):
            fixed = torch.equal(nxt, keep)
        if fixed:
            break
        keep = nxt

    # the first max_out kept boxes in score order
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    take = keep & (rank < max_out)
    slot = torch.where(take, rank, torch.full_like(rank, max_out))
    out = torch.full((*order.shape[:-1], max_out + 1), -1, dtype=torch.int64,
                     device=boxes.device)
    out.scatter_(-1, slot, torch.where(take, order, torch.full_like(order, -1)))
    out_idx = out[..., :max_out]
    return out_idx, out_idx >= 0


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor,
                      classes: torch.Tensor, iou_thresh: float, max_out: int,
                      valid: torch.Tensor | None = None, offset: float = 1.0):
    """Per-class NMS via the coordinate-offset trick (boxes of different
    classes never overlap). boxes (..., N, 4), classes (..., N)."""
    max_coord = boxes.abs().amax(dim=(-2, -1), keepdim=True) + 1.0
    shifted = boxes + classes.to(boxes.dtype)[..., None] * 2.0 * max_coord
    return nms_padded(shifted, scores, iou_thresh, max_out, valid, offset)
