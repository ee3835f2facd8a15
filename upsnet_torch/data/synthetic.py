"""Synthetic scenes: deterministic random images with exact GT.

The rectangles-over-stripes scenes of ``upsnet_tpu/data/synthetic.py``
(``SyntheticDataset._scene``): axis-aligned rectangles ("things") over a
striped stuff background, drawn from ``RandomState(seed * 1000 + i)``, so
boxes, masks and the semantic map are exact. One generator, ``scene``,
serves two callers: ``synthetic_batch`` assembles its scenes straight into
``forward_train``'s batch dict, and ``SyntheticDataset`` serves them through
``BaseDataset`` (resize, bucket, evaluators) as the JAX package's does.
"""

from __future__ import annotations

import numpy as np

from upsnet_torch.config.defaults import Config
from upsnet_torch.data.base import BaseDataset
from upsnet_torch.data.transforms import PIXEL_MEANS_BGR

IGNORE = 255


def scene(rng: np.random.RandomState, image_hw, num_things: int, num_stuff: int):
    """One scene: uint8 image (H, W, 3), boxes (n, 4) float32, classes (n,)
    int32 in 1..num_things, masks (n, H, W) uint8, seg (H, W) int32."""
    h, w = image_hw
    img = np.zeros((h, w, 3), np.uint8)
    seg = np.zeros((h, w), np.int32)
    n_bands = min(num_stuff, 4)
    for b in range(n_bands):
        y0, y1 = h * b // n_bands, h * (b + 1) // n_bands
        img[y0:y1] = (40 * (b + 1)) % 200 + 20
        seg[y0:y1] = b % num_stuff
    n_inst = rng.randint(1, 4)
    boxes, classes, masks = [], [], []
    for _ in range(n_inst):
        bw = rng.randint(w // 6, w // 3)
        bh = rng.randint(h // 6, h // 3)
        x1 = rng.randint(0, w - bw - 1)
        y1 = rng.randint(0, h - bh - 1)
        cls = rng.randint(1, num_things + 1)
        img[y1:y1 + bh, x1:x1 + bw] = np.array(
            [50 + 60 * (cls % 3), 80 + 50 * (cls % 4), 120 + 40 * (cls % 2)], np.uint8)
        m = np.zeros((h, w), np.uint8)
        m[y1:y1 + bh, x1:x1 + bw] = 1
        seg[y1:y1 + bh, x1:x1 + bw] = num_stuff + cls - 1
        boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
        classes.append(cls)
        masks.append(m)
    return (img, np.array(boxes, np.float32).reshape(-1, 4), np.array(classes, np.int32),
            np.array(masks, np.uint8).reshape(-1, h, w), seg)


def synthetic_batch(cfg: Config, bucket, batch_size: int, seed: int,
                    image_hw=None) -> dict:
    """A training batch of ``batch_size`` scenes of size ``image_hw``
    (default: the bucket) on a ``bucket`` canvas: images (B, H, W, 3)
    float32, mean-subtracted, zero beyond the image; im_hw (B, 2); gt_boxes
    (B, G, 4), gt_classes (B, G) int32, gt_valid (B, G) bool, gt_masks
    (B, G, H/4, W/4) uint8 and seg_gt (B, H/4, W/4) int32 (255 beyond the
    image), with G = ``cfg.train.max_gt_instances``."""
    bh, bw = bucket
    ih, iw = image_hw or bucket
    if ih > bh or iw > bw or bh % 4 or bw % 4:
        raise ValueError(f"image {image_hw} must fit the bucket {bucket} (multiples of 4)")
    g = cfg.train.max_gt_instances
    qh, qw = bh // 4, bw // 4
    out = {
        "images": np.zeros((batch_size, bh, bw, 3), np.float32),
        "im_hw": np.tile(np.array([ih, iw], np.float32), (batch_size, 1)),
        "gt_boxes": np.zeros((batch_size, g, 4), np.float32),
        "gt_classes": np.zeros((batch_size, g), np.int32),
        "gt_valid": np.zeros((batch_size, g), bool),
        "gt_masks": np.zeros((batch_size, g, qh, qw), np.uint8),
        "seg_gt": np.full((batch_size, qh, qw), IGNORE, np.int32),
    }
    for i in range(batch_size):
        rng = np.random.RandomState(seed * 1000 + i)
        img, boxes, classes, masks, seg = scene(
            rng, (ih, iw), cfg.dataset.num_classes - 1, cfg.dataset.num_stuff)
        n = min(len(boxes), g)
        out["images"][i, :ih, :iw] = img.astype(np.float32) - PIXEL_MEANS_BGR
        out["gt_boxes"][i, :n] = boxes[:n]
        out["gt_classes"][i, :n] = classes[:n]
        out["gt_valid"][i, :n] = True
        # nearest-sample the labels at 1/4 scale, as the data layer does
        mq = masks[:n, 2::4, 2::4]
        out["gt_masks"][i, :n, :mq.shape[1], :mq.shape[2]] = mq
        sq = seg[2::4, 2::4]
        out["seg_gt"][i, :sq.shape[0], :sq.shape[1]] = sq
    return out


class SyntheticDataset(BaseDataset):
    """``num_images`` scenes of ``image_hw``, image i drawn by ``scene`` from
    ``RandomState(seed * 1000 + i)``: the images and GT of
    ``upsnet_tpu/data/synthetic.py:SyntheticDataset``, bit for bit."""

    def __init__(self, cfg: Config, num_images: int = 8, image_hw=(256, 320),
                 training: bool = True, seed: int = 0):
        super().__init__(cfg, training)
        self.num_images = num_images
        self.image_hw = image_hw
        self.seed = seed
        self.num_things = cfg.dataset.num_classes - 1
        self.num_stuff = cfg.dataset.num_stuff

    def __len__(self):
        return self.num_images

    def _scene(self, i: int):
        img, boxes, classes, masks, seg = scene(
            np.random.RandomState(self.seed * 1000 + i), self.image_hw, self.num_things,
            self.num_stuff)
        return img, {"boxes": boxes, "classes": classes, "masks": masks, "seg": seg}

    def load_image(self, i: int) -> np.ndarray:
        return self._scene(i)[0]

    def load_gt(self, i: int) -> dict:
        return self._scene(i)[1]
