"""Dataset abstraction (the port's copy of ``upsnet_tpu/data/base.py``).

Reference: ``upsnet/dataset/base_dataset.py`` (SURVEY.md §2.4) — a
Detectron-style roidb plus ``evaluate_*`` methods. Here: a ``BaseDataset``
producing static-shape numpy samples (see ``sample`` contract below) and the
same four evaluation entry points, backed by the port's own evaluators
(``upsnet_torch/evaluation/``).

Sample contract (train):
  image     (BH, BW, 3) float32 — normalized BGR in a static bucket
  im_hw     (2,) float32 — actual (resized) content extent in the canvas
  scale     () float32 — resize factor from the original image
  gt_boxes  (G, 4) float32, gt_classes (G,) int32 (1-based), gt_valid (G,)
  gt_masks  (G, BH/4, BW/4) uint8 — instance masks at 1/4 canvas scale
  seg_gt    (BH/4, BW/4) int32 — semantic labels, stuff first, 255 ignore
Test adds: image_id, orig_hw.
"""

from __future__ import annotations

import numpy as np

from upsnet_torch.data import transforms as T


class BaseDataset:
    """Subclasses implement __len__, record(i) -> dict with keys:
    file (path or loader), height, width, image_id, and a gt(i) -> dict with
    boxes (N, 4) xyxy, classes (N,), masks-at-full-res provider, seg labels.
    """

    def __init__(self, cfg, training: bool):
        self.cfg = cfg
        self.training = training
        tc = cfg.train if training else cfg.test
        self.scales = tuple(tc.scales)
        self.max_size = tc.max_size
        self.buckets = tuple(tuple(b) for b in tc.image_buckets)
        self.max_gt = cfg.train.max_gt_instances
        # Built-sample cache (train.sample_cache_mb > 0, training only):
        # given (index, scale, flip) the whole preprocessing pipeline is
        # deterministic, so on small repeatedly-epoched datasets (the
        # rehearsal configs) every sample after the first epoch or two is
        # a dict lookup instead of a PNG decode + rasterize + resize.
        # Insertion stops at the byte cap; lookups keep working, misses
        # just rebuild.
        cap_mb = getattr(cfg.train, "sample_cache_mb", 0)
        self._cache: dict | None = (
            {} if training and cap_mb and cap_mb > 0 else None
        )
        self._cache_cap = int(cap_mb) * (1 << 20)
        self._cache_bytes = 0

    # ---- subclass API ----
    def __len__(self):
        raise NotImplementedError

    def load_image(self, i: int) -> np.ndarray:
        """(H, W, 3) uint8 BGR."""
        raise NotImplementedError

    def load_gt(self, i: int) -> dict:
        """boxes (N,4) xyxy float, classes (N,) int 1-based, masks (N,H,W)
        uint8, seg (H, W) int32 with 255 ignore; optional crowd_boxes
        (Nc, 4) xyxy iscrowd regions (ignore, not supervision)."""
        raise NotImplementedError

    def image_id(self, i: int):
        return i

    # ---- sample construction ----
    def test_sample(self, i: int, canvas, orig_hw, scale: float, content_hw) -> dict:
        """The sample's test keys around ``canvas`` (a numpy array here, a
        tensor on the device from TTA's samples)."""
        return {
            "images": canvas,
            "im_hw": np.array(content_hw, np.float32),
            "scale": np.float32(scale),
            "image_id": np.int64(self.image_id(i)),
            "orig_hw": np.array(orig_hw, np.int64),
        }

    def sample(self, i: int, rng: np.random.RandomState | None = None,
               target_scale: int | None = None, hflip: bool = False) -> dict:
        """Build one preprocessed sample. ``target_scale``/``hflip`` override
        the config (used by multi-scale / flip test-time augmentation).

        Draws (scale, flip) from ``rng`` — the ONLY stochastic choices —
        then delegates to the deterministic ``_build_sample``, which is
        cached when ``train.sample_cache_mb`` is set."""
        rng = rng or np.random
        if target_scale is not None:
            target = target_scale
        elif self.training:
            target = self.scales[rng.randint(len(self.scales))]
        else:
            target = self.scales[0]
        flipped = hflip
        if self.training and self.cfg.train.flip and rng.rand() < 0.5:
            flipped = True

        if self._cache is None:
            return self._build_sample(i, target, flipped)
        key = (i, target, flipped)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        s = self._build_sample(i, target, flipped)
        if self._cache_bytes < self._cache_cap:
            self._cache[key] = s
            self._cache_bytes += sum(
                np.asarray(v).nbytes for v in s.values()
            )
        return s

    def _build_sample(self, i: int, target: int, flipped: bool) -> dict:
        """Deterministic sample build for a fixed (index, scale, flip)."""
        img = self.load_image(i).astype(np.float32)
        h, w = img.shape[:2]
        scale, (rh, rw), bucket = T.variant_geometry(h, w, target, self.max_size, self.buckets)
        img = T.normalize_bgr(T.resize_image(img, scale))

        gt = self.load_gt(i) if self.training else None
        if flipped:
            img = T.flip_image(img).copy()

        out = self.test_sample(i, T.pad_to_bucket(img, bucket), (h, w), scale, (rh, rw))
        if not self.training:
            return out

        g = self.max_gt
        qh, qw = bucket[0] // 4, bucket[1] // 4
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), bool)
        gt_masks = np.zeros((g, qh, qw), np.uint8)
        seg_full = gt["seg"]

        import cv2

        # resize GT to the resized image, then flip, then quarter-scale
        seg_r = cv2.resize(
            seg_full.astype(np.int32), (rw, rh), interpolation=cv2.INTER_NEAREST
        )
        if flipped:
            seg_r = seg_r[:, ::-1]
        seg_q = np.full((qh, qw), 255, np.int32)
        sq = T.downsample_label(seg_r, 4)
        seg_q[: sq.shape[0], : sq.shape[1]] = sq

        boxes = gt["boxes"] * scale
        if flipped:
            boxes = T.flip_boxes_np(boxes, rw)
        n = min(len(boxes), g)
        order = np.argsort(
            -(boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        )[:n] if len(boxes) > g else np.arange(n)
        for slot, j in enumerate(order):
            gt_boxes[slot] = np.clip(
                boxes[j], [0, 0, 0, 0], [rw - 1, rh - 1, rw - 1, rh - 1]
            )
            gt_classes[slot] = gt["classes"][j]
            gt_valid[slot] = True
            m = gt["masks"][j]
            mr = cv2.resize(m, (rw, rh), interpolation=cv2.INTER_NEAREST)
            if flipped:
                mr = mr[:, ::-1]
            mq = T.downsample_label(mr, 4)
            gt_masks[slot, : mq.shape[0], : mq.shape[1]] = mq

        # iscrowd regions -> static-padded ignore boxes (Detectron lineage:
        # excluded from the negative pools in ops/targets.py)
        gc = self.cfg.train.max_crowd_instances
        crowd_boxes = np.zeros((gc, 4), np.float32)
        crowd_valid = np.zeros((gc,), bool)
        cb = gt.get("crowd_boxes")
        if cb is not None and len(cb):
            cb = np.asarray(cb, np.float32) * scale
            if flipped:
                cb = T.flip_boxes_np(cb, rw)
            nc = min(len(cb), gc)
            crowd_boxes[:nc] = np.clip(
                cb[:nc], [0, 0, 0, 0], [rw - 1, rh - 1, rw - 1, rh - 1]
            )
            crowd_valid[:nc] = True

        out.update(
            gt_boxes=gt_boxes,
            gt_classes=gt_classes,
            gt_valid=gt_valid,
            gt_masks=gt_masks,
            seg_gt=seg_q,
            crowd_boxes=crowd_boxes,
            crowd_valid=crowd_valid,
        )
        return out

    # ---- evaluation entry points (reference API, SURVEY.md §2.4) ----
    # Default implementations build GT on the fly from load_gt(); datasets
    # with external annotation formats (COCO) override them. Category-id
    # conventions for PQ: stuff = semantic train ids [0, num_stuff);
    # things = num_stuff + det_label - 1.

    def _index_of_image_id(self):
        return {int(self.image_id(i)): i for i in range(len(self))}

    def _add_gt_boxes(self, ev, want_masks: bool):
        from upsnet_torch.evaluation import rle as rle_mod

        for i in range(len(self)):
            gt = self.load_gt(i)
            img_id = int(self.image_id(i))
            for j in range(len(gt["classes"])):
                x1, y1, x2, y2 = gt["boxes"][j]
                g = {
                    "image_id": img_id,
                    "category_id": int(gt["classes"][j]),
                    "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1],
                    "area": float((x2 - x1 + 1) * (y2 - y1 + 1)),
                    "iscrowd": 0,
                }
                if want_masks:
                    g["segmentation"] = rle_mod.encode(gt["masks"][j])
                ev.add_gt(g)

    def evaluate_boxes(self, detections) -> dict:
        from upsnet_torch.evaluation.coco_eval import COCOEvaluator

        ev = COCOEvaluator("bbox", max_dets=self.cfg.test.max_det)
        self._add_gt_boxes(ev, want_masks=False)
        for d in detections:
            x1, y1, x2, y2 = d["bbox"]
            ev.add_det({"image_id": d["image_id"], "category_id": int(d["category"]),
                        "score": float(d["score"]),
                        "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1]})
        return ev.summarize()

    def evaluate_masks(self, detections) -> dict:
        from upsnet_torch.evaluation.coco_eval import COCOEvaluator

        ev = COCOEvaluator("segm", max_dets=self.cfg.test.max_det)
        self._add_gt_boxes(ev, want_masks=True)
        for d in detections:
            x1, y1, x2, y2 = d["bbox"]
            ev.add_det({"image_id": d["image_id"], "category_id": int(d["category"]),
                        "score": float(d["score"]),
                        "segmentation": d["segmentation"],
                        "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1]})
        return ev.summarize()

    def evaluate_ssegs(self, seg_preds) -> dict:
        from upsnet_torch.evaluation.seg_eval import ConfusionMatrix

        index = self._index_of_image_id()
        cm = ConfusionMatrix(self.cfg.dataset.num_seg_classes)
        for p in seg_preds:
            gt = self.load_gt(index[int(p["image_id"])])["seg"]
            cm.update(gt, p["pred"])
        return {"mIoU": cm.mean_iou(), "pixel_acc": cm.pixel_accuracy()}

    def evaluate_panoptic(self, pan_results) -> dict:
        from upsnet_torch.evaluation.pq import (
            PQStat,
            pq_compute_single_image,
            pq_summarize,
        )

        if isinstance(pan_results, str):  # path to written pred.json
            from upsnet_torch.evaluation.panoptic_format import (
                read_panoptic_results,
            )

            pan_results = read_panoptic_results(pan_results)

        num_stuff = self.cfg.dataset.num_stuff
        index = self._index_of_image_id()
        stat = PQStat()
        for p in pan_results:
            gt = self.load_gt(index[int(p["image_id"])])
            seg = gt["seg"]
            gt_map = np.zeros(seg.shape, np.int64)
            gt_segments = {}
            next_id = 1
            for s in range(num_stuff):
                m = seg == s
                if not m.any():
                    continue
                gt_map[m] = next_id
                gt_segments[next_id] = {"category_id": s, "iscrowd": 0}
                next_id += 1
            for j in range(len(gt["classes"])):
                m = gt["masks"][j] > 0
                gt_map[m] = next_id
                gt_segments[next_id] = {
                    "category_id": num_stuff + int(gt["classes"][j]) - 1,
                    "iscrowd": 0,
                }
                next_id += 1
            pred_segments = {
                s["id"]: {"category_id": s["category_id"]} for s in p["segments"]
            }
            stat += pq_compute_single_image(
                gt_map, p["id_map"], gt_segments, pred_segments
            )
        things = set(range(num_stuff, self.cfg.dataset.num_seg_classes))
        stuff = set(range(num_stuff))
        return pq_summarize(stat, things, stuff)
