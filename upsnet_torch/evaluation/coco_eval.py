"""COCO-style detection / instance-segmentation AP.

Reimplements the COCOeval protocol the reference uses through pycocotools
(``evaluate_boxes`` / ``evaluate_masks``, SURVEY.md §2.4): greedy per-image
matching of score-sorted detections to GT at IoU thresholds 0.50:0.05:0.95,
crowd GT as ignore regions, area-range filtering, 101-point interpolated
precision, AP averaged over classes and thresholds.

IoU conventions match pycocotools: boxes are xywh with width = w (no +1);
mask IoU via the RLE codec in evaluation/rle.py with iscrowd semantics.
The port's copy of ``upsnet_tpu/evaluation/coco_eval.py``; it needs no
``pycocotools``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from upsnet_torch.evaluation import rle as rle_mod

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd) -> np.ndarray:
    """(D, 4) x (G, 4) xywh IoU, crowd GT uses det area as denominator."""
    d_area = dets[:, 2] * dets[:, 3]
    g_area = gts[:, 2] * gts[:, 3]
    ious = np.zeros((len(dets), len(gts)))
    for j, g in enumerate(gts):
        x1 = np.maximum(dets[:, 0], g[0])
        y1 = np.maximum(dets[:, 1], g[1])
        x2 = np.minimum(dets[:, 0] + dets[:, 2], g[0] + g[2])
        y2 = np.minimum(dets[:, 1] + dets[:, 3], g[1] + g[3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        denom = d_area if iscrowd[j] else d_area + g_area[j] - inter
        ious[:, j] = np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)
    return ious


def mask_iou(det_rles, gt_rles, iscrowd) -> np.ndarray:
    ious = np.zeros((len(det_rles), len(gt_rles)))
    for i, dr in enumerate(det_rles):
        for j, gr in enumerate(gt_rles):
            ious[i, j] = rle_mod.iou(dr, gr, iscrowd=bool(iscrowd[j]))
    return ious


class COCOEvaluator:
    """Accumulates per-image matches, then summarizes AP/AR.

    detections: list of dicts {image_id, category_id, score, bbox (xywh)
    or segmentation (RLE)}; ground truth via add_gt with
    {image_id, category_id, bbox/segmentation, iscrowd, area}.
    """

    def __init__(self, iou_type: str = "bbox", max_dets: int = 100):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        self.max_dets = max_dets
        self.gts = defaultdict(list)  # (image_id, cat) -> list
        self.dets = defaultdict(list)
        self.cats = set()
        self.images = set()

    def add_gt(self, ann: dict):
        self.gts[(ann["image_id"], ann["category_id"])].append(ann)
        self.cats.add(ann["category_id"])
        self.images.add(ann["image_id"])

    def add_det(self, det: dict):
        self.dets[(det["image_id"], det["category_id"])].append(det)
        self.images.add(det["image_id"])

    def _iou(self, dets, gts):
        if self.iou_type == "bbox":
            d = np.array([x["bbox"] for x in dets], np.float64).reshape(-1, 4)
            g = np.array([x["bbox"] for x in gts], np.float64).reshape(-1, 4)
            crowd = [x.get("iscrowd", 0) for x in gts]
            return box_iou_xywh(d, g, crowd)
        d = [x["segmentation"] for x in dets]
        g = [x["segmentation"] for x in gts]
        crowd = [x.get("iscrowd", 0) for x in gts]
        return mask_iou(d, g, crowd)

    def _evaluate_img(self, img, cat, area_rng):
        gts = self.gts.get((img, cat), [])
        dets = self.dets.get((img, cat), [])
        if not gts and not dets:
            return None
        dets = sorted(dets, key=lambda x: -x["score"])[: self.max_dets]
        # IoUs are area-range independent: compute once per (img, cat) in
        # original gt order, reindex per range (4 ranges share one matrix)
        if not hasattr(self, "_iou_cache"):
            self._iou_cache = {}
        cache_key = (img, cat)
        if cache_key not in self._iou_cache:
            self._iou_cache[cache_key] = (
                self._iou(dets, gts) if gts and dets
                else np.zeros((len(dets), len(gts)))
            )
        ious_orig = self._iou_cache[cache_key]
        lo, hi = area_rng
        g_ignore = np.array(
            [
                bool(g.get("iscrowd", 0)) or not (lo <= g.get("area", 0.0) < hi)
                for g in gts
            ],
            dtype=bool,
        )
        # sort gts: non-ignored first (pycocotools order)
        order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in order]
        g_ignore = g_ignore[order]
        ious = ious_orig[:, order]

        t = len(IOU_THRS)
        d_match = np.zeros((t, len(dets)), np.int64) - 1
        g_match = np.zeros((t, len(gts)), np.int64) - 1
        d_ignore = np.zeros((t, len(dets)), bool)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(len(dets)):
                best = thr
                best_j = -1
                for gj in range(len(gts)):
                    if g_match[ti, gj] >= 0 and not gts[gj].get("iscrowd", 0):
                        continue
                    # stop at ignored gts once a real match was found
                    if best_j >= 0 and not g_ignore[best_j] and g_ignore[gj]:
                        break
                    if ious[di, gj] < best:
                        continue
                    best = ious[di, gj]
                    best_j = gj
                if best_j >= 0:
                    d_match[ti, di] = best_j
                    g_match[ti, best_j] = di
                    d_ignore[ti, di] = g_ignore[best_j]
        # unmatched dets outside the area range are ignored
        d_area_out = np.array(
            [
                not (lo <= x["bbox"][2] * x["bbox"][3] < hi)
                if self.iou_type == "bbox" and "bbox" in x
                else not (lo <= _det_area(x) < hi)
                for x in dets
            ],
            dtype=bool,
        )
        d_ignore |= (d_match == -1) & d_area_out[None, :]
        return {
            "scores": np.array([x["score"] for x in dets]),
            "d_match": d_match,
            "d_ignore": d_ignore,
            "n_gt": int((~g_ignore).sum()),
        }

    def _accumulate(self, area_rng, max_dets_list):
        """Per-category AP (at the largest maxDets) and AR per maxDets.

        pycocotools semantics: detections are truncated PER IMAGE to
        maxDets (in score order) before pooling across images.
        """
        t = len(IOU_THRS)
        n_cat = len(self.cats)
        md_max = max(max_dets_list)
        ap = np.full((t, n_cat), np.nan)
        ar = {md: np.full((t, n_cat), np.nan) for md in max_dets_list}
        for ci, cat in enumerate(sorted(self.cats)):
            results = [
                r
                for img in sorted(self.images)
                if (r := self._evaluate_img(img, cat, area_rng)) is not None
            ]
            if not results:
                continue
            n_gt = sum(r["n_gt"] for r in results)
            if n_gt == 0:
                continue
            for md in max_dets_list:
                scores = np.concatenate([r["scores"][:md] for r in results])
                order = np.argsort(-scores, kind="mergesort")
                matches = np.concatenate(
                    [r["d_match"][:, :md] for r in results], axis=1
                )[:, order]
                ignores = np.concatenate(
                    [r["d_ignore"][:, :md] for r in results], axis=1
                )[:, order]
                for ti in range(t):
                    keep = ~ignores[ti]
                    tp = np.cumsum((matches[ti] >= 0) & keep)
                    fp = np.cumsum((matches[ti] < 0) & keep)
                    recall = tp / n_gt
                    ar[md][ti, ci] = recall[-1] if len(recall) else 0.0
                    if md != md_max:
                        continue
                    precision = tp / np.maximum(tp + fp, 1e-12)
                    # precision envelope
                    for k in range(len(precision) - 1, 0, -1):
                        precision[k - 1] = max(precision[k - 1], precision[k])
                    # 101-point interpolation
                    idx = np.searchsorted(recall, RECALL_THRS, side="left")
                    prec_at = (
                        np.where(
                            idx < len(precision),
                            precision[np.minimum(idx, max(len(precision) - 1, 0))],
                            0.0,
                        )
                        if len(precision)
                        else np.zeros_like(RECALL_THRS)
                    )
                    ap[ti, ci] = prec_at.mean()
        return ap, ar

    def summarize(self) -> dict:
        """Full 12-metric COCOeval table (the reference prints this via
        pycocotools summarize(), SURVEY.md §2.4): AP/AP50/AP75, area-range
        APs/APm/APl, AR@1/10/100 and area-range ARs/ARm/ARl."""
        self._iou_cache = {}
        md = self.max_dets
        md_list = sorted({1, 10, md})

        def mean(x):
            return float(np.nanmean(x)) if np.isfinite(x).any() else float("nan")

        ap_all, ar_all = self._accumulate(AREA_RANGES["all"], md_list)
        out = {
            "AP": mean(ap_all),
            "AP50": mean(ap_all[0]),
            "AP75": mean(ap_all[5]),
            f"AR@{md}": mean(ar_all[md]),
            "AR@1": mean(ar_all[1]) if 1 in ar_all else float("nan"),
            "AR@10": mean(ar_all[10]) if 10 in ar_all else float("nan"),
            # back-compat alias used by earlier tests/tools
            "AR": mean(ar_all[md]),
        }
        for name, key_ap, key_ar in (
            ("small", "APs", "ARs"),
            ("medium", "APm", "ARm"),
            ("large", "APl", "ARl"),
        ):
            ap_a, ar_a = self._accumulate(AREA_RANGES[name], [md])
            out[key_ap] = mean(ap_a)
            out[key_ar] = mean(ar_a[md])
        self._iou_cache = {}
        return out


METRIC_ORDER = (
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR@1", "AR@10", "AR@100", "ARs", "ARm", "ARl",
)

_TABLE_ROWS = (
    ("Average Precision", "AP", "0.50:0.95", "all"),
    ("Average Precision", "AP50", "0.50", "all"),
    ("Average Precision", "AP75", "0.75", "all"),
    ("Average Precision", "APs", "0.50:0.95", "small"),
    ("Average Precision", "APm", "0.50:0.95", "medium"),
    ("Average Precision", "APl", "0.50:0.95", "large"),
    ("Average Recall", "AR@1", "0.50:0.95", "all"),
    ("Average Recall", "AR@10", "0.50:0.95", "all"),
    ("Average Recall", "AR@100", "0.50:0.95", "all"),
    ("Average Recall", "ARs", "0.50:0.95", "small"),
    ("Average Recall", "ARm", "0.50:0.95", "medium"),
    ("Average Recall", "ARl", "0.50:0.95", "large"),
)


def format_table(metrics: dict, max_dets: int = 100) -> str:
    """pycocotools-style 12-line summary table."""
    lines = []
    for kind, key, iou, area in _TABLE_ROWS:
        if key == "AR@100" and key not in metrics:
            key = f"AR@{max_dets}"
        md = int(key.split("@")[1]) if "@" in key else max_dets
        v = metrics.get(key, float("nan"))
        tag = "(AP)" if kind == "Average Precision" else "(AR)"
        lines.append(
            f" {kind:<17} {tag} @[ IoU={iou:<9} | area={area:>6} | "
            f"maxDets={md:>3} ] = {v:0.3f}"
        )
    return "\n".join(lines)


def _det_area(det: dict) -> float:
    if "area" in det:
        return det["area"]
    if "segmentation" in det:
        return float(rle_mod.area(det["segmentation"]))
    b = det["bbox"]
    return float(b[2] * b[3])
