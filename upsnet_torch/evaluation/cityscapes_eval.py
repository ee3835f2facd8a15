"""Cityscapes instance-segmentation AP, cityscapesScripts protocol (the
port's copy of ``upsnet_tpu/evaluation/cityscapes_eval.py``).

The reference evaluates Cityscapes instance masks through the vendored
``cityscapesScripts`` ``evalInstanceLevelSemanticLabeling`` (SURVEY.md
§2.4), whose protocol differs from COCOeval in ways that move AP by
points (VERDICT r1 item #7):

  * matching is per-GT: among all predictions overlapping a GT with
    IoU > threshold, the highest-confidence one is the TP; every further
    match becomes an FP at its own confidence;
  * a prediction matching no GT is an FP unless the fraction of its
    pixels lying on void / group-annotation / undersized GT regions of
    its class exceeds the overlap threshold (then it is discarded);
  * GT instances below ``min_region_size`` (100 px for gtFine) are not
    counted in the recall denominator and act as ignore regions;
  * group annotations ("car group": instanceId == labelId, no *1000)
    are never matchable, only ignore;
  * AP integrates the precision-recall operating points with midpoint
    step widths ((r_{i+1} - r_{i-1}) / 2, boundary-clamped) — the
    trapezoid the cityscapesScripts convolution computes — over
    overlaps 0.50:0.05:0.95; the table reports the overlap mean (AP)
    and AP at 0.50 (AP50%).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZE = 100  # gtFine


def _ap_from_points(y_true: np.ndarray, y_score: np.ndarray, n_gt: int):
    """AP from labeled (TP=1 / FP=0) scored examples, cityscapesScripts
    integration (midpoint step widths over unique-score operating points)."""
    if n_gt == 0:
        return float("nan")
    if len(y_score) == 0:
        return 0.0
    order = np.argsort(-y_score, kind="stable")
    yt = y_true[order]
    ys = y_score[order]
    tp = np.cumsum(yt)
    fp = np.cumsum(1 - yt)
    # operating points: last index of each unique score (descending)
    last = np.nonzero(np.append(ys[1:] != ys[:-1], True))[0]
    recall = tp[last] / float(n_gt)
    precision = tp[last] / np.maximum(tp[last] + fp[last], 1e-12)
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0]], precision])
    nxt = np.append(r[1:], r[-1])
    prv = np.concatenate([[r[0]], r[:-1]])
    widths = (nxt - prv) / 2.0
    return float(np.dot(p, widths))


class CityscapesInstanceEvaluator:
    """Accumulates per-image instance matches, then computes per-class AP.

    add_image() consumes dense masks so intersections are exact; only
    per-pair statistics are retained (memory stays per-instance)."""

    def __init__(self, num_classes: int, overlaps=OVERLAPS,
                 min_region_size: int = MIN_REGION_SIZE):
        self.num_classes = num_classes  # thing classes, labels 1..N
        self.overlaps = np.asarray(overlaps)
        self.min_region_size = min_region_size
        # per class: list of gt records / pred records
        self.gt_by_class = defaultdict(list)
        self.pred_by_class = defaultdict(list)

    def add_image(
        self,
        gt_masks: np.ndarray,      # (G, H, W) uint8/bool instance masks
        gt_classes: np.ndarray,    # (G,) int 1..N
        pred_masks: list,          # list of (H, W) uint8/bool
        pred_classes: np.ndarray,  # (P,) int 1..N
        pred_scores: np.ndarray,   # (P,)
        void_mask: np.ndarray | None = None,   # (H, W) bool
        group_masks: dict | None = None,       # class -> (H, W) bool
    ):
        group_masks = group_masks or {}
        g_areas = np.array([int(m.sum()) for m in gt_masks], np.int64)
        g_small = g_areas < self.min_region_size
        # per-class: register counted GT instances
        gt_ids = {}
        for gi in range(len(gt_masks)):
            c = int(gt_classes[gi])
            if g_small[gi]:
                continue
            gt_ids[gi] = len(self.gt_by_class[c])
            self.gt_by_class[c].append({"matches": []})  # (score, pred ref)

        for pi, pm in enumerate(pred_masks):
            c = int(pred_classes[pi])
            pm = pm.astype(bool)
            p_area = int(pm.sum())
            if p_area == 0:
                continue
            score = float(pred_scores[pi])
            overlaps = []  # (gt index within class, iou)
            ignore_inter = 0
            if void_mask is not None:
                ignore_inter += int((pm & void_mask).sum())
            if c in group_masks:
                ignore_inter += int((pm & group_masks[c]).sum())
            for gi in range(len(gt_masks)):
                if int(gt_classes[gi]) != c:
                    continue
                inter = int((pm & gt_masks[gi].astype(bool)).sum())
                if inter == 0:
                    continue
                if g_small[gi]:
                    ignore_inter += inter  # undersized GT: ignore region
                    continue
                iou = inter / float(g_areas[gi] + p_area - inter)
                overlaps.append((gt_ids[gi], iou))
            pred_rec = {
                "score": score,
                "area": p_area,
                "ignore_frac": ignore_inter / float(p_area),
                "overlaps": overlaps,
            }
            self.pred_by_class[c].append(pred_rec)
            for gid, iou in overlaps:
                self.gt_by_class[c][gid]["matches"].append((iou, score))

    def _class_ap(self, c: int, thr: float) -> float:
        gts = self.gt_by_class.get(c, [])
        preds = self.pred_by_class.get(c, [])
        n_gt = len(gts)
        y_true, y_score = [], []
        for g in gts:
            ms = sorted(
                (s for iou, s in g["matches"] if iou > thr), reverse=True
            )
            if ms:
                y_true.append(1)
                y_score.append(ms[0])
                for s in ms[1:]:  # further matches to the same GT are FPs
                    y_true.append(0)
                    y_score.append(s)
        for p in preds:
            if any(iou > thr for _, iou in p["overlaps"]):
                continue  # accounted through its GT above
            if p["ignore_frac"] > thr:
                continue  # mostly void/group/undersized: discarded
            y_true.append(0)
            y_score.append(p["score"])
        return _ap_from_points(
            np.asarray(y_true, np.float64), np.asarray(y_score, np.float64),
            n_gt,
        )

    def summarize(self, class_names=None) -> dict:
        per_class = {}
        for c in range(1, self.num_classes + 1):
            if not self.gt_by_class.get(c) and not self.pred_by_class.get(c):
                continue
            aps = np.array([self._class_ap(c, t) for t in self.overlaps])
            name = class_names[c - 1] if class_names else c
            per_class[name] = {
                "ap": float(np.nanmean(aps)),
                "ap50": float(aps[0]),
            }
        vals = [v["ap"] for v in per_class.values() if np.isfinite(v["ap"])]
        vals50 = [v["ap50"] for v in per_class.values()
                  if np.isfinite(v["ap50"])]
        return {
            "allAp": float(np.mean(vals)) if vals else float("nan"),
            "allAp50%": float(np.mean(vals50)) if vals50 else float("nan"),
            "classes": per_class,
        }
