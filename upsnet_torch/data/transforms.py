"""Image + GT preprocessing (the port's copy of ``upsnet_tpu/data/transforms.py``).

Reference semantics (uber-research/UPSNet ``upsnet/dataset/base_dataset.py``,
SURVEY.md §2.4): BGR channel order, 0-255 range, per-channel caffe mean
subtraction (102.9801, 115.9465, 122.7717) with NO std division; resize
shorter side to ``scales[k]`` capped so the longer side <= ``max_size``;
horizontal flip augmentation flips boxes/masks/segmap together.

Instead of the reference's pad-to-max-in-batch, images land in one of a
small set of static buckets (H, W multiples of 64), as in the JAX package;
the port keeps its bucket keys, because anchors are built per bucket.
"""

from __future__ import annotations

import numpy as np

PIXEL_MEANS_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)


def compute_resize_scale(h: int, w: int, target: int, max_size: int) -> float:
    scale = target / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = max_size / max(h, w)
    return scale


def resized_hw(h: int, w: int, scale: float) -> tuple[int, int]:
    """The size of an (h, w) image resized by ``scale``."""
    return int(round(h * scale)), int(round(w * scale))


def resize_image(img: np.ndarray, scale: float) -> np.ndarray:
    """Bilinear resize by a scale factor. img (H, W, C) float32."""
    import cv2

    nh, nw = resized_hw(*img.shape[:2], scale)
    return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)


def normalize_bgr(img_bgr: np.ndarray) -> np.ndarray:
    return img_bgr.astype(np.float32) - PIXEL_MEANS_BGR


def pick_bucket(h: int, w: int, buckets) -> tuple[int, int]:
    """Smallest bucket that fits (h, w); falls back to the largest."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    return max(buckets, key=lambda b: b[0] * b[1])


def variant_geometry(h: int, w: int, target: int, max_size: int, buckets) -> tuple:
    """The host arithmetic of one sample of an (h, w) image at ``target``:
    (scale, content (rh, rw), bucket (BH, BW)). ``BaseDataset._build_sample``
    and TTA's samples built on the device both take it from here."""
    scale = compute_resize_scale(h, w, target, max_size)
    rh, rw = resized_hw(h, w, scale)
    return scale, (rh, rw), pick_bucket(rh, rw, buckets)


def pad_to_bucket(img: np.ndarray, bucket: tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    bh, bw = bucket
    out = np.zeros((bh, bw) + img.shape[2:], img.dtype)
    out[: min(h, bh), : min(w, bw)] = img[: min(h, bh), : min(w, bw)]
    return out


def flip_image(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def flip_boxes_np(boxes: np.ndarray, width: int) -> np.ndarray:
    out = boxes.copy()
    out[:, 0] = width - 1.0 - boxes[:, 2]
    out[:, 2] = width - 1.0 - boxes[:, 0]
    return out


def downsample_label(label: np.ndarray, factor: int) -> np.ndarray:
    """Nearest-sample a label map by an integer factor (seg GT to 1/4)."""
    return label[factor // 2 :: factor, factor // 2 :: factor]
