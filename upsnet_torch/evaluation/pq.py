"""Panoptic Quality (PQ) computation.

Reimplements the panopticapi ``pq_compute`` algorithm (Kirillov et al.,
"Panoptic Segmentation", CVPR 2019) that the reference calls via its
vendored ``lib/dataset_devkit/panopticapi`` (SURVEY.md §2.4):

  * per image: segments are regions of a (H, W) id map plus per-segment
    category info; matches are (same category, IoU > 0.5), where
    union excludes the prediction's overlap with GT VOID;
  * unmatched GT -> FN (crowd GT excluded); unmatched prediction -> FP
    unless > 0.5 of it lies on VOID + same-category crowd GT;
  * PQ = sum IoU / (TP + FP/2 + FN/2), SQ = sum IoU / TP,
    RQ = TP / (TP + FP/2 + FN/2); averaged over categories seen in GT.

Operates on dense id maps (numpy) — the on-device panoptic head produces
those directly, no PNG round-trip needed for self-evaluation. The port's
copy of ``upsnet_tpu/evaluation/pq.py``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

VOID = 0  # reserved id in panoptic id maps


@dataclass
class PQStat:
    iou_sum: defaultdict = field(default_factory=lambda: defaultdict(float))
    tp: defaultdict = field(default_factory=lambda: defaultdict(int))
    fp: defaultdict = field(default_factory=lambda: defaultdict(int))
    fn: defaultdict = field(default_factory=lambda: defaultdict(int))

    def __iadd__(self, other: "PQStat"):
        for d_self, d_other in (
            (self.iou_sum, other.iou_sum),
            (self.tp, other.tp),
            (self.fp, other.fp),
            (self.fn, other.fn),
        ):
            for k, v in d_other.items():
                d_self[k] += v
        return self

    def categories(self):
        return set(self.iou_sum) | set(self.tp) | set(self.fp) | set(self.fn)


def pq_compute_single_image(
    pan_gt: np.ndarray,  # (H, W) int segment ids, VOID = 0
    pan_pred: np.ndarray,  # (H, W) int segment ids, VOID = 0
    gt_segments: dict,  # id -> {"category_id": int, "iscrowd": 0/1}
    pred_segments: dict,  # id -> {"category_id": int}
) -> PQStat:
    stat = PQStat()
    pan_gt = pan_gt.astype(np.uint64)
    pan_pred = pan_pred.astype(np.uint64)

    # joint histogram of (gt_id, pred_id) pairs
    offset = np.uint64(2**32)
    combined = pan_gt * offset + pan_pred
    ids, counts = np.unique(combined, return_counts=True)
    inter = {}
    for cid, cnt in zip(ids, counts):
        gt_id = int(cid // offset)
        pred_id = int(cid % offset)
        inter[(gt_id, pred_id)] = int(cnt)

    gt_areas = defaultdict(int)
    pred_areas = defaultdict(int)
    for (g, p), c in inter.items():
        gt_areas[g] += c
        pred_areas[p] += c

    matched_gt, matched_pred = set(), set()
    for (g, p), c in inter.items():
        if g == VOID or p == VOID:
            continue
        if g not in gt_segments or p not in pred_segments:
            continue
        gseg, pseg = gt_segments[g], pred_segments[p]
        if gseg.get("iscrowd", 0) == 1:
            continue
        if gseg["category_id"] != pseg["category_id"]:
            continue
        void_inter = inter.get((VOID, p), 0)
        union = gt_areas[g] + pred_areas[p] - c - void_inter
        iou = c / union if union > 0 else 0.0
        if iou > 0.5:
            cat = gseg["category_id"]
            stat.tp[cat] += 1
            stat.iou_sum[cat] += iou
            matched_gt.add(g)
            matched_pred.add(p)

    crowd_by_cat = {}
    for g, seg in gt_segments.items():
        if seg.get("iscrowd", 0) == 1:
            crowd_by_cat[seg["category_id"]] = g
            continue
        if g not in matched_gt:
            stat.fn[seg["category_id"]] += 1

    for p, seg in pred_segments.items():
        if p in matched_pred:
            continue
        ignored = inter.get((VOID, p), 0)
        crowd_g = crowd_by_cat.get(seg["category_id"])
        if crowd_g is not None:
            ignored += inter.get((crowd_g, p), 0)
        if pred_areas.get(p, 0) > 0 and ignored / pred_areas[p] > 0.5:
            continue  # mostly over void/crowd: not an FP
        stat.fp[seg["category_id"]] += 1

    return stat


def pq_summarize(stat: PQStat, thing_categories=None, stuff_categories=None):
    """Per-category PQ/SQ/RQ + averages. Returns a dict like panopticapi."""

    def avg(cats):
        pqs, sqs, rqs, n = 0.0, 0.0, 0.0, 0
        for c in cats:
            tp, fp, fn = stat.tp[c], stat.fp[c], stat.fn[c]
            if tp + fp + fn == 0:
                continue
            denom = tp + 0.5 * fp + 0.5 * fn
            pq = stat.iou_sum[c] / denom if denom else 0.0
            sq = stat.iou_sum[c] / tp if tp else 0.0
            rq = tp / denom if denom else 0.0
            pqs += pq
            sqs += sq
            rqs += rq
            n += 1
        n = max(n, 1)
        return {"pq": pqs / n, "sq": sqs / n, "rq": rqs / n, "n": n}

    cats = stat.categories()
    out = {"All": avg(cats)}
    if thing_categories is not None:
        out["Things"] = avg([c for c in cats if c in set(thing_categories)])
    if stuff_categories is not None:
        out["Stuff"] = avg([c for c in cats if c in set(stuff_categories)])
    per_cat = {}
    for c in sorted(cats):
        per_cat[c] = avg([c])
    out["per_category"] = per_cat
    return out
