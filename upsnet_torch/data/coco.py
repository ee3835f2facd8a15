"""COCO panoptic dataset (the port's copy of ``upsnet_tpu/data/coco.py``).

Reference: uber-research/UPSNet ``upsnet/dataset/coco.py`` (SURVEY.md §2.4):
80 thing + 53 stuff classes; instance GT from ``instances_*.json``
(Mask R-CNN branch), semantic/panoptic GT from ``panoptic_*.json`` + PNGs;
four evaluate_* methods. pycocotools/panopticapi are replaced by the
framework's own parsers/evaluators (evaluation/), including polygon
rasterization via PIL and the RLE codec.

Expected layout (reference ``data/coco`` symlink layout):
  {root}/annotations/instances_{set}.json
  {root}/annotations/panoptic_{set}.json
  {root}/annotations/panoptic_{set}/  (PNGs)
  {root}/{set}/  (images)

Class id conventions inside the framework:
  * detection labels: 1..80 (0 = background), in instances-json category
    order (sorted by category id — pycocotools convention);
  * semantic train ids: stuff 0..52 (panoptic stuff categories sorted by
    id), things 53..132 as ``52 + det_label``; 255 = ignore/unlabeled.
"""

from __future__ import annotations

import json
import os
from functools import cached_property

import numpy as np

from upsnet_torch.data.base import BaseDataset
from upsnet_torch.evaluation import rle as rle_mod
from upsnet_torch.evaluation.coco_eval import COCOEvaluator
from upsnet_torch.evaluation.panoptic_format import rgb_to_id
from upsnet_torch.evaluation.pq import PQStat, pq_compute_single_image, pq_summarize
from upsnet_torch.evaluation.seg_eval import ConfusionMatrix


def rasterize_polygons(polys, h: int, w: int) -> np.ndarray:
    """COCO polygon list -> (H, W) uint8 mask (PIL rasterization)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for p in polys:
        if len(p) >= 6:
            draw.polygon([tuple(p[i : i + 2]) for i in range(0, len(p), 2)],
                         outline=1, fill=1)
    return np.asarray(img, np.uint8)


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):
        return rasterize_polygons(seg, h, w)
    # RLE: counts may be a raw list (uncompressed) or string (compressed)
    return rle_mod.decode({"size": seg["size"], "counts": seg["counts"]})


class COCOPanoptic(BaseDataset):
    def __init__(self, cfg, image_set: str | None = None, training: bool = True):
        super().__init__(cfg, training)
        self.root = cfg.dataset.dataset_path
        self.image_set = image_set or (
            cfg.dataset.image_set if training else cfg.dataset.test_image_set
        )
        self._load_annotations()

    # ------------------------------------------------------------------
    def _ann_path(self, name):
        return os.path.join(self.root, "annotations", name)

    def _load_annotations(self):
        inst_file = self._ann_path(f"instances_{self.image_set}.json")
        pan_file = self._ann_path(f"panoptic_{self.image_set}.json")
        with open(inst_file) as f:
            inst = json.load(f)
        self.images = sorted(inst["images"], key=lambda x: x["id"])
        self.img_index = {im["id"]: i for i, im in enumerate(self.images)}
        # detection label mapping (sorted category ids -> 1..80)
        thing_cats = sorted(c["id"] for c in inst["categories"])
        self.thing_cat_to_label = {c: i + 1 for i, c in enumerate(thing_cats)}
        self.label_to_thing_cat = {v: k for k, v in self.thing_cat_to_label.items()}
        self.anns_by_image: dict[int, list] = {im["id"]: [] for im in self.images}
        for a in inst["annotations"]:
            if a["image_id"] in self.anns_by_image:
                self.anns_by_image[a["image_id"]].append(a)

        self.pan_by_image = {}
        self.stuff_cat_ids: list[int] = []
        if os.path.exists(pan_file):
            with open(pan_file) as f:
                pan = json.load(f)
            stuff = sorted(
                c["id"] for c in pan["categories"] if not c.get("isthing", 0)
            )
            self.stuff_cat_ids = stuff
            self.stuff_cat_to_train = {c: i for i, c in enumerate(stuff)}
            self.pan_categories = {c["id"]: c for c in pan["categories"]}
            for a in pan["annotations"]:
                self.pan_by_image[a["image_id"]] = a
        else:
            self.stuff_cat_to_train = {}
            self.pan_categories = {}

    @cached_property
    def num_stuff(self):
        return len(self.stuff_cat_ids) or self.cfg.dataset.num_stuff

    def __len__(self):
        return len(self.images)

    def image_id(self, i: int):
        return self.images[i]["id"]

    def load_image(self, i: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.root, self.image_set, self.images[i]["file_name"])
        img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise FileNotFoundError(path)
        return img

    def _semantic_from_panoptic(self, i: int, h: int, w: int) -> np.ndarray:
        """(H, W) semantic train-id map from the panoptic PNG; 255 ignore."""
        info = self.pan_by_image.get(self.images[i]["id"])
        if info is None:
            return np.full((h, w), 255, np.int32)
        import cv2

        png = cv2.imread(
            self._ann_path(
                os.path.join(f"panoptic_{self.image_set}", info["file_name"])
            ),
            cv2.IMREAD_COLOR,
        )
        ids = rgb_to_id(png[:, :, ::-1])  # PNG is RGB; cv2 loads BGR
        seg = np.full((h, w), 255, np.int32)
        for s in info["segments_info"]:
            cat = s["category_id"]
            if cat in self.stuff_cat_to_train:
                train_id = self.stuff_cat_to_train[cat]
            elif cat in self.thing_cat_to_label:
                train_id = self.num_stuff + self.thing_cat_to_label[cat] - 1
            else:
                continue
            seg[ids == s["id"]] = train_id
        return seg

    def load_gt(self, i: int) -> dict:
        im = self.images[i]
        h, w = im["height"], im["width"]
        boxes, classes, masks, crowd = [], [], [], []
        for a in self.anns_by_image.get(im["id"], []):
            x, y, bw, bh = a["bbox"]
            if a.get("iscrowd", 0):
                # crowd regions become ignore boxes (never hard negatives),
                # matching Detectron target assignment (VERDICT r1 #4)
                crowd.append([x, y, x + bw - 1, y + bh - 1])
                continue
            if bw < 2 or bh < 2 or a.get("area", 0) < 4:
                continue
            boxes.append([x, y, x + bw - 1, y + bh - 1])
            classes.append(self.thing_cat_to_label[a["category_id"]])
            masks.append(ann_to_mask(a, h, w))
        return {
            "boxes": np.array(boxes, np.float32).reshape(-1, 4),
            "classes": np.array(classes, np.int32),
            "masks": np.array(masks, np.uint8).reshape(-1, h, w),
            "seg": self._semantic_from_panoptic(i, h, w),
            "crowd_boxes": np.array(crowd, np.float32).reshape(-1, 4),
        }

    # ------------------------------------------------------------------
    # evaluation (reference API)
    # ------------------------------------------------------------------
    def _gt_to_evaluator(self, ev: COCOEvaluator, want_masks: bool):
        for im in self.images:
            h, w = im["height"], im["width"]
            for a in self.anns_by_image.get(im["id"], []):
                x, y, bw, bh = a["bbox"]
                g = {
                    "image_id": im["id"],
                    "category_id": self.thing_cat_to_label[a["category_id"]],
                    "bbox": [x, y, bw, bh],
                    "area": a.get("area", bw * bh),
                    "iscrowd": a.get("iscrowd", 0),
                }
                if want_masks:
                    g["segmentation"] = rle_mod.encode(ann_to_mask(a, h, w))
                ev.add_gt(g)

    def evaluate_boxes(self, detections) -> dict:
        """detections: list of {image_id, category (1-based label), score,
        bbox xyxy} in original-image coordinates."""
        ev = COCOEvaluator("bbox", max_dets=self.cfg.test.max_det)
        self._gt_to_evaluator(ev, want_masks=False)
        for d in detections:
            x1, y1, x2, y2 = d["bbox"]
            ev.add_det(
                {
                    "image_id": d["image_id"],
                    "category_id": int(d["category"]),
                    "score": float(d["score"]),
                    "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                }
            )
        return ev.summarize()

    def evaluate_masks(self, detections) -> dict:
        """detections additionally carry 'segmentation' (RLE at orig size)."""
        ev = COCOEvaluator("segm", max_dets=self.cfg.test.max_det)
        self._gt_to_evaluator(ev, want_masks=True)
        for d in detections:
            x1, y1, x2, y2 = d["bbox"]
            ev.add_det(
                {
                    "image_id": d["image_id"],
                    "category_id": int(d["category"]),
                    "score": float(d["score"]),
                    "segmentation": d["segmentation"],
                    "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                }
            )
        return ev.summarize()

    def evaluate_ssegs(self, seg_preds) -> dict:
        """seg_preds: list of {image_id, pred (H, W) train ids at orig res}."""
        cm = ConfusionMatrix(self.cfg.dataset.num_seg_classes)
        for p in seg_preds:
            i = self.img_index[p["image_id"]]
            im = self.images[i]
            gt = self._semantic_from_panoptic(i, im["height"], im["width"])
            cm.update(gt, p["pred"])
        return {"mIoU": cm.mean_iou(), "pixel_acc": cm.pixel_accuracy()}

    def evaluate_panoptic(self, pan_results) -> dict:
        """pan_results: list of {image_id, id_map (H, W), segments (list)}
        at original resolution (segments use dataset category ids), OR a
        path to a written pred.json (artifact-level evaluation, matching
        the reference's file-based pq_compute)."""
        if isinstance(pan_results, str):
            from upsnet_torch.evaluation.panoptic_format import (
                read_panoptic_results,
            )

            pan_results = read_panoptic_results(pan_results)
        stat = PQStat()
        for p in pan_results:
            info = self.pan_by_image.get(p["image_id"])
            if info is None:
                continue
            import cv2

            png = cv2.imread(
                self._ann_path(
                    os.path.join(f"panoptic_{self.image_set}", info["file_name"])
                ),
                cv2.IMREAD_COLOR,
            )
            gt_ids = rgb_to_id(png[:, :, ::-1])
            gt_segments = {
                s["id"]: {
                    "category_id": s["category_id"],
                    "iscrowd": s.get("iscrowd", 0),
                }
                for s in info["segments_info"]
            }
            pred_segments = {
                s["id"]: {"category_id": s["category_id"]} for s in p["segments"]
            }
            stat += pq_compute_single_image(
                gt_ids, p["id_map"], gt_segments, pred_segments
            )
        things = set(self.label_to_thing_cat.values())
        stuff = set(self.stuff_cat_ids)
        return pq_summarize(stat, things, stuff)
