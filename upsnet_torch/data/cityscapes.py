"""Cityscapes dataset, fine annotations (the port's copy of
``upsnet_tpu/data/cityscapes.py``).

Reference: uber-research/UPSNet ``upsnet/dataset/cityscapes.py``
(SURVEY.md §2.4): 19 classes = 11 stuff (trainIds 0-10) + 8 things
(trainIds 11-18: person, rider, car, truck, bus, train, motorcycle,
bicycle); instance GT from ``*_instanceIds.png`` (id = labelId * 1000 + k
for things); eval via instance AP / mIoU / PQ — here through the
framework's own evaluators.

Expected layout:
  {root}/leftImg8bit/{split}/{city}/*_leftImg8bit.png
  {root}/gtFine/{split}/{city}/*_gtFine_labelIds.png / *_instanceIds.png

Framework conventions: detection labels 1..8 (thing trainId - 10);
semantic train ids = cityscapes trainIds (stuff first by construction).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from upsnet_torch.data.base import BaseDataset

# labelId -> trainId (cityscapesScripts table, 255 = ignore)
LABEL_TO_TRAIN = np.full(256, 255, np.int32)
for lid, tid in {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}.items():
    LABEL_TO_TRAIN[lid] = tid

THING_TRAIN_IDS = tuple(range(11, 19))
NUM_STUFF = 11
# labelIds of things, aligned with detection labels 1..8
THING_LABEL_IDS = (24, 25, 26, 27, 28, 31, 32, 33)


class Cityscapes(BaseDataset):
    def __init__(self, cfg, split: str | None = None, training: bool = True):
        super().__init__(cfg, training)
        self.root = cfg.dataset.dataset_path
        # split precedence: explicit arg > config image sets (reference
        # semantics: dataset.image_set / test_image_set) > train/val
        cfg_split = (cfg.dataset.image_set if training
                     else cfg.dataset.test_image_set)
        self.split = split or cfg_split or ("train" if training else "val")
        pattern = os.path.join(
            self.root, "leftImg8bit", self.split, "*", "*_leftImg8bit.png"
        )
        self.files = sorted(glob.glob(pattern))
        if not self.files:
            raise FileNotFoundError(pattern)

    def __len__(self):
        return len(self.files)

    def image_id(self, i: int):
        return i

    def _gt_path(self, i: int, kind: str) -> str:
        f = self.files[i]
        rel = os.path.relpath(f, os.path.join(self.root, "leftImg8bit"))
        rel = rel.replace("_leftImg8bit.png", f"_gtFine_{kind}.png")
        return os.path.join(self.root, "gtFine", rel)

    def load_image(self, i: int) -> np.ndarray:
        import cv2

        img = cv2.imread(self.files[i], cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.files[i])
        return img

    def load_gt(self, i: int) -> dict:
        import cv2

        label = cv2.imread(self._gt_path(i, "labelIds"), cv2.IMREAD_UNCHANGED)
        inst = cv2.imread(self._gt_path(i, "instanceIds"), cv2.IMREAD_UNCHANGED)
        inst = inst.astype(np.int32)
        h, w = label.shape[:2]
        seg = LABEL_TO_TRAIN[label.astype(np.int32)]
        boxes, classes, masks = [], [], []
        for iid in np.unique(inst):
            if iid < 1000:  # stuff / group labels carry no instance id
                continue
            label_id = iid // 1000
            if label_id not in THING_LABEL_IDS:
                continue
            m = (inst == iid).astype(np.uint8)
            ys, xs = np.nonzero(m)
            if len(ys) < 8:
                continue
            boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
            classes.append(THING_LABEL_IDS.index(label_id) + 1)
            masks.append(m)
        return {
            "boxes": np.array(boxes, np.float32).reshape(-1, 4),
            "classes": np.array(classes, np.int32),
            "masks": np.array(masks, np.uint8).reshape(-1, h, w),
            "seg": seg,
        }

    # evaluation: boxes/ssegs/panoptic use the BaseDataset defaults (stuff =
    # trainIds 0-10, thing category = num_stuff + det_label - 1 = trainIds
    # 11-18). Instance masks use the cityscapesScripts protocol the
    # reference reports (paper Table 4), NOT COCO AP (VERDICT r1 item #7).

    def evaluate_masks(self, detections) -> dict:
        """cityscapesScripts ``evalInstanceLevelSemanticLabeling`` AP.

        detections: list of {image_id, category (1..8), score,
        segmentation (RLE at original resolution)}.
        """
        import cv2

        from upsnet_torch.evaluation import rle as rle_mod
        from upsnet_torch.evaluation.cityscapes_eval import (
            CityscapesInstanceEvaluator,
        )

        by_image = {}
        for d in detections:
            by_image.setdefault(int(d["image_id"]), []).append(d)
        ev = CityscapesInstanceEvaluator(num_classes=len(THING_LABEL_IDS))
        for i in range(len(self)):
            label = cv2.imread(self._gt_path(i, "labelIds"),
                               cv2.IMREAD_UNCHANGED).astype(np.int32)
            inst = cv2.imread(self._gt_path(i, "instanceIds"),
                              cv2.IMREAD_UNCHANGED).astype(np.int32)
            void_mask = LABEL_TO_TRAIN[label] == 255
            gt_masks, gt_classes = [], []
            group_masks = {}
            for iid in np.unique(inst):
                label_id = iid // 1000 if iid >= 1000 else iid
                if label_id not in THING_LABEL_IDS:
                    continue
                cls = THING_LABEL_IDS.index(label_id) + 1
                m = inst == iid
                if iid < 1000:  # group annotation -> ignore region
                    group_masks[cls] = group_masks.get(
                        cls, np.zeros_like(m)) | m
                    continue
                gt_masks.append(m.astype(np.uint8))
                gt_classes.append(cls)
            dets = by_image.get(int(self.image_id(i)), [])
            pred_masks = [rle_mod.decode(d["segmentation"]) for d in dets]
            ev.add_image(
                np.array(gt_masks, np.uint8).reshape(
                    (-1,) + label.shape),
                np.array(gt_classes, np.int32),
                pred_masks,
                np.array([d["category"] for d in dets], np.int32),
                np.array([d["score"] for d in dets], np.float64),
                void_mask=void_mask,
                group_masks=group_masks,
            )
        names = ("person", "rider", "car", "truck", "bus", "train",
                 "motorcycle", "bicycle")
        return ev.summarize(class_names=names)
