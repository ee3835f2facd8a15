"""Multi-scale + horizontal-flip test-time augmentation, the port's copy of
``upsnet_tpu/evaluation/tta.py``.

Per image:
  1. every (scale, flip) runs the ordinary predict step (``predict_step``
     with the full float32 semantic logits, no on-device argmax);
  2. semantic logits are de-flipped, cropped to content, resized to the
     original resolution (cv2, on the host) and averaged;
  3. detections are mapped to original coordinates (de-flip + unscale),
     concatenated, per-class-NMS'd on the host (greedy), the top
     ``max_det`` kept; mask logits follow their detection (de-flipped);
  4. fusion runs the single-scale path's ``panoptic_fuse`` on the model's
     device, on the merged evidence resampled to the first variant's
     quarter-scale canvas.

A reference behaviour is copied with the rest: where a scale's canvas fits
no ``test.image_buckets``, ``pick_bucket`` takes the largest and
``pad_to_bucket`` crops the image to it, while ``im_hw`` keeps the uncropped
size, so the semantic crop of step 2 reads beyond the map and stretches what
is there over the whole image.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from upsnet_torch.config.defaults import Config
from upsnet_torch.models.upsnet import panoptic_fuse


def _greedy_nms_per_class(boxes, scores, classes, thresh, max_out):
    order = np.argsort(-scores, kind="stable")
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= max_out:
            break
        same = classes == classes[i]
        xx1 = np.maximum(boxes[i, 0], boxes[:, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[:, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(xx2 - xx1 + 1, 0) * np.maximum(yy2 - yy1 + 1, 0)
        iou = inter / (areas[i] + areas - inter)
        suppressed |= same & (iou > thresh)
    return np.array(keep, np.int64)


def _fuse_device(seg_lg, boxes, classes, ms_logits, scores, valid, *, device,
                 score_thresh: float, overlap_thresh: float, num_stuff: int):
    """The single-scale path's ``panoptic_fuse`` on ``device`` for one image
    of host arrays; returns (pan_map, keep) as numpy."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a))[None].to(device)

    pan, keep = panoptic_fuse(
        dev(seg_lg), dev(boxes), dev(classes.astype(np.int64)), dev(ms_logits), dev(scores),
        dev(valid), score_thresh=score_thresh, overlap_thresh=overlap_thresh,
        num_stuff=num_stuff)
    return pan[0].cpu().numpy(), keep[0].cpu().numpy()


def fuse_tta(cfg: Config, seg_avg, boxes, scores, classes, mask_logits,
             base_scale: float, bucket: tuple, content_hw: tuple, device="cpu"):
    """Fuse TTA-merged evidence with ``panoptic_fuse`` on ``device``.

    seg_avg (oh, ow, C) averaged logits at ORIGINAL resolution; detections
    in original coordinates. Evidence is resampled onto the base bucket's
    quarter-scale canvas (the frame the single-scale path fuses in), fused,
    and the channel map is mapped back to original resolution.

    Returns (pan_map (oh, ow) int32 channel indices, keep (max_det,) bool,
    padded detection arrays in original coords).
    """
    import cv2

    oh, ow = seg_avg.shape[:2]
    rh, rw = content_hw
    qh, qw = bucket[0] // 4, bucket[1] // 4
    cqh, cqw = max(rh // 4, 1), max(rw // 4, 1)
    seg_q = cv2.resize(seg_avg, (cqw, cqh), interpolation=cv2.INTER_LINEAR)
    seg_canvas = np.zeros((qh, qw, seg_avg.shape[-1]), np.float32)
    seg_canvas[:cqh, :cqw] = seg_q

    d = cfg.test.max_det
    pb = np.zeros((d, 4), np.float32)
    ps = np.zeros((d,), np.float32)
    pc = np.zeros((d,), np.int32)
    pm = np.zeros((d,) + mask_logits.shape[1:], np.float32)
    pv = np.zeros((d,), bool)
    n = min(len(boxes), d)
    pb[:n] = boxes[:n] * base_scale  # orig -> base-canvas coords
    ps[:n] = scores[:n]
    pc[:n] = classes[:n]
    pm[:n] = mask_logits[:n]
    pv[:n] = True

    pan_q, keep = _fuse_device(
        seg_canvas, pb, pc, pm, ps, pv, device=device,
        score_thresh=float(cfg.test.panoptic_score_thresh),
        overlap_thresh=float(cfg.test.panoptic_mask_overlap_thresh),
        num_stuff=int(cfg.dataset.num_stuff),
    )
    pan_q = pan_q[:cqh, :cqw]
    pan_full = cv2.resize(
        pan_q.astype(np.int32), (ow, oh), interpolation=cv2.INTER_NEAREST
    )
    return pan_full, keep, (pb / base_scale, ps, pc, pm, pv)


def tta_variants(cfg: Config) -> list:
    """The (scale, flip) pairs of one image, in the order they run:
    ``test.scales`` then the ``multi_scale`` ones not among them, each
    unflipped then (``flip_test``) flipped."""
    scales = list(cfg.test.scales) + [
        s for s in cfg.test.multi_scale if s not in cfg.test.scales
    ]
    flips = [False, True] if cfg.test.flip_test else [False]
    return [(ts, fl) for ts in scales for fl in flips]


def predict_image_tta(cfg: Config, dataset, i: int, predict, device="cpu",
                      timings: dict | None = None):
    """Run every (scale, flip) variant of image ``i`` through
    ``predict(bucket, sample) -> outputs`` (numpy, full f32 ``seg_logits``)
    and merge them; returns the same output contract as
    ``postprocess_image`` consumes, already in original coordinates. Where
    ``timings`` is given, the seconds spent building samples, predicting,
    merging and fusing are added to it."""
    import cv2

    clock = dict.fromkeys(("sample_s", "predict_s", "merge_s", "fuse_s"), 0.0)
    seg_sum = None
    n_seg = 0
    all_boxes, all_scores, all_classes, all_masks = [], [], [], []
    oh = ow = None
    image_id = None
    base = None  # (scale, bucket, content_hw) of the first variant
    for ts, fl in tta_variants(cfg):
        t0 = time.perf_counter()
        s = dataset.sample(i, target_scale=ts, hflip=fl)
        oh, ow = (int(v) for v in s["orig_hw"])
        image_id = s["image_id"]
        rh, rw = (int(v) for v in s["im_hw"])
        bucket = tuple(s["images"].shape[:2])
        if base is None:
            base = (float(s["scale"]), bucket, (rh, rw))
        t1 = time.perf_counter()
        out = predict(bucket, s)
        t2 = time.perf_counter()
        # semantic: crop content, de-flip, resize to orig, accumulate
        seg = out["seg_logits"][: max(rh // 4, 1), : max(rw // 4, 1)]
        if fl:
            seg = seg[:, ::-1]
        seg = cv2.resize(seg, (ow, oh), interpolation=cv2.INTER_LINEAR)
        seg_sum = seg if seg_sum is None else seg_sum + seg
        n_seg += 1
        # detections to original coords
        valid = out["det_valid"]
        boxes = out["boxes"][valid]
        masks = out["mask_logits"][valid]
        if fl:
            x1 = rw - 1.0 - boxes[:, 2]
            x2 = rw - 1.0 - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], -1)
            masks = masks[:, :, ::-1]
        boxes = boxes / float(s["scale"])
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow - 1)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh - 1)
        all_boxes.append(boxes)
        all_scores.append(out["scores"][valid])
        all_classes.append(out["classes"][valid])
        all_masks.append(masks)
        t3 = time.perf_counter()
        clock["sample_s"] += t1 - t0
        clock["predict_s"] += t2 - t1
        clock["merge_s"] += t3 - t2

    t0 = time.perf_counter()
    boxes = np.concatenate(all_boxes, 0)
    scores = np.concatenate(all_scores, 0)
    classes = np.concatenate(all_classes, 0)
    masks = np.concatenate(all_masks, 0)
    keep = _greedy_nms_per_class(
        boxes, scores, classes, cfg.test.nms_thresh, cfg.test.max_det
    )
    order = keep[np.argsort(-scores[keep], kind="stable")]
    boxes, scores, classes, masks = (
        boxes[order], scores[order], classes[order], masks[order],
    )
    seg_avg = seg_sum / n_seg
    t1 = time.perf_counter()
    base_scale, base_bucket, content_hw = base
    pan_map, pan_keep, padded = fuse_tta(
        cfg, seg_avg, boxes, scores, classes, masks,
        base_scale, base_bucket, content_hw, device,
    )
    pb, ps, pc, pm, pv = padded
    n = int(pv.sum())
    result = {
        "image_id": image_id,
        "orig_hw": (oh, ow),
        "boxes": pb[:n],
        "scores": ps[:n],
        "classes": pc[:n],
        "mask_logits": pm[:n],
        "seg_pred": seg_avg.argmax(-1).astype(np.int32),
        "pan_map": pan_map,
        "pan_keep": pan_keep[:n],
    }
    clock["merge_s"] += t1 - t0
    clock["fuse_s"] += time.perf_counter() - t1
    if timings is not None:
        for k, v in clock.items():
            timings[k] = timings.get(k, 0.0) + v
    return result
