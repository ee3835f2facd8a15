"""Semantic-segmentation mIoU via confusion matrix.

Reference: ``evaluate_ssegs`` in the dataset classes (SURVEY.md §2.4) — a
num_seg_classes x num_seg_classes confusion matrix over all pixels with
label != 255, then per-class IoU and the mean. The port's copy of
``upsnet_tpu/evaluation/seg_eval.py``.
"""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    def __init__(self, num_classes: int, ignore: int = 255):
        self.num_classes = num_classes
        self.ignore = ignore
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, gt: np.ndarray, pred: np.ndarray):
        valid = gt != self.ignore
        g = gt[valid].astype(np.int64)
        p = pred[valid].astype(np.int64)
        idx = g * self.num_classes + p
        self.mat += np.bincount(
            idx, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    def iou_per_class(self) -> np.ndarray:
        inter = np.diag(self.mat).astype(np.float64)
        union = self.mat.sum(0) + self.mat.sum(1) - np.diag(self.mat)
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = inter / union
        return iou

    def mean_iou(self) -> float:
        iou = self.iou_per_class()
        return float(np.nanmean(iou))

    def pixel_accuracy(self) -> float:
        total = self.mat.sum()
        return float(np.diag(self.mat).sum() / total) if total else 0.0
