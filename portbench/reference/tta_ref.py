"""Plain float32 multi-scale, flip test-time augmentation (TTA) of UPSNet, for
judging the program's TTA evaluation path.

The published protocol (arXiv:1901.03784, section 4; upstream UPSNet's
``test.multi_scale`` and ``test.flip_test``): each image runs once per test
scale, unflipped and mirrored, and the variants' evidence is merged.

- **Variants**: ``test.scales`` then the ``multi_scale`` ones not among them,
  each unflipped then flipped. A variant's image is the frame resized so that
  its short side is the scale, unless the long side would then pass
  ``max_size`` (then the long side is ``max_size``), bilinearly with
  half-pixel centres; the caffe means subtracted; mirrored; laid at the
  top-left of the smallest ``image_buckets`` canvas that holds it (the
  largest, cropped, where none does).
- **Semantic logits**: each variant's quarter-scale logits cropped to its
  content, de-flipped, resized bilinearly (half-pixel centres, as cv2's
  ``INTER_LINEAR``) to the frame's size, and averaged.
- **Detections**: each variant's kept detections de-flipped in its resized
  frame, divided by its scale, clipped to the frame; all variants'
  together through a greedy NMS within each class at ``test.nms_thresh``
  (legacy +1 areas, descending score, ties to the earlier variant); the
  ``max_det`` best kept; mask logits follow their detection, de-flipped.
- **Fusion**: the averaged logits resized bilinearly to the first variant's
  quarter-scale content and laid on its canvas, the detections scaled into
  that frame, and the reference's own panoptic fusion
  (``upsnet_ref.panoptic_fuse``); the channel map cropped to content and
  resized to the frame by nearest neighbour (cv2's rule: source index
  ``floor(dst * src / dst_size)``).

Departures from upstream UPSNet, all of them the program's protocol as well,
so that the program is judged against what it claims to compute:
- upstream pads each scale's image to a multiple of 32; here every variant
  runs on the configuration's fixed canvas (``test.image_buckets``);
- upstream merges the panoptic head's own logits per scale; here the fusion
  runs once, on the merged semantic logits and detections, at the first
  variant's quarter scale;
- a variant that outgrows every canvas is cropped to the largest while its
  content size stays uncropped (the program's copy of the JAX package's
  behaviour); the benchmark's traffic never reaches it.

Everything is plain ``torch`` and ``numpy`` in float32 with TF32 off
(``upsnet_ref.no_tf32``). Nothing of the program is imported.

``judge_tta`` holds the program's TTA of one frame to it:
- ``tta_seg_err``: relative L2 of the program's merged full-resolution
  semantic logits against the reference's merge of the reference's own
  variants;
- ``tta_det_err``: the program's merged detections against the reference's
  merge of the program's own variant outputs (each detection's nearest of
  its class: score gap plus coordinate gap over its longer side; the sorted
  scores; the mask logits of the nearest, as a relative L2); infinite where
  the program's variants are not the configuration's;
- ``tta_pan_gap``: the program's full-resolution panoptic map judged, pixel
  by pixel, by the stack of panoptic logits that the reference builds from
  its own merged semantic logits and the program's merged detections, mask
  logits and keep flags: the widest gap of the chosen channel below the
  best, over the std of the logits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.compare import rel
from portbench.reference.upsnet_ref import iou, panoptic_fuse, panoptic_stack

PIXEL_MEANS_BGR = torch.tensor([102.9801, 115.9465, 122.7717])
NUMBERS = ("tta_seg_err", "tta_det_err", "tta_pan_gap")


def variants(test: dict) -> list:
    """The (scale, flip) pairs of one image, in the order they run."""
    scales = list(test["scales"]) + [s for s in test["multi_scale"] if s not in test["scales"]]
    flips = [False, True] if test["flip_test"] else [False]
    return [(s, f) for s in scales for f in flips]


def resize_scale(h: int, w: int, target: int, max_size: int) -> float:
    scale = target / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = max_size / max(h, w)
    return scale


def bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(C, H, W) -> (C, *size), half-pixel centres, edges held, no
    antialiasing (cv2's ``INTER_LINEAR``)."""
    if tuple(x.shape[1:]) == tuple(size):
        return x
    return F.interpolate(x[None], size=tuple(size), mode="bilinear", align_corners=False)[0]


def nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(H, W) -> size by cv2's nearest rule."""
    h, w = x.shape
    iy = torch.clamp(torch.arange(size[0], device=x.device) * h // size[0], max=h - 1)
    ix = torch.clamp(torch.arange(size[1], device=x.device) * w // size[1], max=w - 1)
    return x[iy][:, ix]


def variant_canvas(h: int, w: int, scale_to: int, test: dict):
    """A frame of (h, w) at scale ``scale_to``: (scale, content (rh, rw),
    canvas (bh, bw))."""
    scale = resize_scale(h, w, scale_to, test["max_size"])
    rh, rw = int(round(h * scale)), int(round(w * scale))
    fitting = [b for b in test["image_buckets"] if b[0] >= rh and b[1] >= rw]
    bh, bw = (min(fitting, key=lambda b: b[0] * b[1]) if fitting
              else max(test["image_buckets"], key=lambda b: b[0] * b[1]))
    return scale, (rh, rw), (bh, bw)


def variant_image(frame: torch.Tensor, scale_to: int, flip: bool, test: dict):
    """frame (H, W, 3) uint8 BGR -> (canvas (BH, BW, 3) float32
    mean-subtracted, im_hw (rh, rw), scale)."""
    scale, (rh, rw), (bh, bw) = variant_canvas(*frame.shape[:2], scale_to, test)
    img = bilinear(frame.float().permute(2, 0, 1), (rh, rw)).permute(1, 2, 0)
    img = img - PIXEL_MEANS_BGR.to(img.device)
    if flip:
        img = img.flip(1)
    canvas = torch.zeros((bh, bw, 3), device=img.device)
    canvas[:min(rh, bh), :min(rw, bw)] = img[:bh, :bw]
    return canvas, (float(rh), float(rw)), scale


def merge_seg(outs: list, orig_hw) -> torch.Tensor:
    """Each variant's seg_logits (H/4, W/4, C), its content (rh, rw) and its
    flip -> the average at the frame's size, (oh, ow, C)."""
    total = None
    for v in outs:
        rh, rw = (int(x) for x in v["im_hw"])
        seg = torch.as_tensor(v["seg_logits"]).float()[:max(rh // 4, 1), :max(rw // 4, 1)]
        if v["flip"]:
            seg = seg.flip(1)
        seg = bilinear(seg.permute(2, 0, 1), orig_hw).permute(1, 2, 0)
        total = seg if total is None else total + seg
    return total / len(outs)


def greedy_nms_per_class(boxes, scores, classes, thresh: float, max_out: int) -> torch.Tensor:
    """Kept indices in descending score order (ties to the lower index):
    a box is dropped when a kept box of its class overlaps it above
    ``thresh``."""
    order = torch.sort(-scores, stable=True).indices
    over = (iou(boxes[order], boxes[order]) > thresh) & (classes[order][:, None]
                                                          == classes[order][None, :])
    over = over.cpu().numpy()
    alive = np.ones(len(order), bool)
    keep = []
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) >= max_out:
            break
        alive[i + 1:] &= ~over[i, i + 1:]
    return order[torch.as_tensor(keep, dtype=torch.long, device=order.device)]


def merge_detections(outs: list, orig_hw, test: dict) -> dict:
    """Every variant's kept detections in the frame's coordinates, through
    the per-class NMS, the ``max_det`` best: boxes, scores, classes,
    mask_logits in descending score order."""
    oh, ow = orig_hw
    parts = {"boxes": [], "scores": [], "classes": [], "mask_logits": []}
    for v in outs:
        valid = torch.as_tensor(v["det_valid"]).bool()
        boxes = torch.as_tensor(v["boxes"]).float()[valid]
        masks = torch.as_tensor(v["mask_logits"]).float()[valid]
        if v["flip"]:
            rw = float(v["im_hw"][1])
            boxes = torch.stack([rw - 1.0 - boxes[:, 2], boxes[:, 1], rw - 1.0 - boxes[:, 0],
                                 boxes[:, 3]], -1)
            masks = masks.flip(-1)
        boxes = boxes / float(v["scale"])
        boxes = torch.stack([boxes[:, 0].clamp(0, ow - 1), boxes[:, 1].clamp(0, oh - 1),
                             boxes[:, 2].clamp(0, ow - 1), boxes[:, 3].clamp(0, oh - 1)], -1)
        parts["boxes"].append(boxes)
        parts["scores"].append(torch.as_tensor(v["scores"]).float()[valid])
        parts["classes"].append(torch.as_tensor(v["classes"]).long()[valid])
        parts["mask_logits"].append(masks)
    cat = {k: torch.cat(v) for k, v in parts.items()}
    keep = greedy_nms_per_class(cat["boxes"], cat["scores"], cat["classes"],
                                test["nms_thresh"], test["max_det"])
    return {k: v[keep] for k, v in cat.items()}


def fuse(seg_avg: torch.Tensor, dets: dict, base: dict, model_cfg: dict):
    """The merged evidence fused at the first variant's quarter scale.
    Returns (pan_map (oh, ow), keep (max_det,))."""
    test, num_stuff = model_cfg["test"], model_cfg["dataset"]["num_stuff"]
    oh, ow = seg_avg.shape[:2]
    seg_q, pad = quarter_evidence(seg_avg, dets, base, test["max_det"])
    pan, keep = panoptic_fuse(seg_q, pad["boxes"], pad["classes"], pad["mask_logits"],
                              pad["scores"], pad["valid"], test["panoptic_score_thresh"],
                              test["panoptic_mask_overlap_thresh"], num_stuff)
    cqh, cqw = content_q(base)
    return nearest(pan[:cqh, :cqw], (oh, ow)), keep


def content_q(base: dict) -> tuple:
    rh, rw = (int(x) for x in base["im_hw"])
    return max(rh // 4, 1), max(rw // 4, 1)


def quarter_evidence(seg_avg, dets: dict, base: dict, max_det: int):
    """The averaged logits on the first variant's quarter canvas, and the
    merged detections padded to ``max_det`` slots in its frame."""
    bh, bw = base["bucket"]
    cqh, cqw = content_q(base)
    seg_q = torch.zeros((bh // 4, bw // 4, seg_avg.shape[-1]), device=seg_avg.device)
    seg_q[:cqh, :cqw] = bilinear(seg_avg.permute(2, 0, 1), (cqh, cqw)).permute(1, 2, 0)
    n = min(len(dets["scores"]), max_det)
    dev = seg_avg.device
    m = dets["mask_logits"].shape[-1]
    pad = {"boxes": torch.zeros((max_det, 4), device=dev),
           "scores": torch.zeros(max_det, device=dev),
           "classes": torch.zeros(max_det, dtype=torch.long, device=dev),
           "mask_logits": torch.zeros((max_det, m, m), device=dev),
           "valid": torch.arange(max_det, device=dev) < n}
    pad["boxes"][:n] = dets["boxes"][:n].to(dev) * float(base["scale"])
    pad["scores"][:n] = dets["scores"][:n].to(dev)
    pad["classes"][:n] = dets["classes"][:n].to(dev)
    pad["mask_logits"][:n] = dets["mask_logits"][:n].to(dev)
    return seg_q, pad


def run_variants(ref, frame: torch.Tensor, model_cfg: dict, keep=lambda s, f: True) -> list:
    """The reference's (or, ``ref`` built with ``fp8``, the control's) output
    of every variant of one frame that ``keep(scale, flip)`` admits, with
    the variant's scale, flip, content size and canvas."""
    test = model_cfg["test"]
    outs = []
    with torch.no_grad():
        for s, f in variants(test):
            if not keep(s, f):
                continue
            canvas, hw, scale = variant_image(frame, s, f, test)
            out = ref.predict(canvas, hw)
            outs.append({"target": s, "flip": f, "scale": scale, "im_hw": hw,
                         "bucket": tuple(canvas.shape[:2]), "canvas": canvas,
                         **{k: out[k] for k in ("seg_logits", "boxes", "scores", "classes",
                                                "det_valid", "mask_logits")}})
    return outs


def tta(outs: list, orig_hw, model_cfg: dict) -> dict:
    """The merge and fusion of the variants ``outs``: the program's result
    contract (merged seg_logits, detections, pan_map, pan_keep)."""
    with torch.no_grad():
        seg_avg = merge_seg(outs, orig_hw)
        dets = merge_detections(outs, orig_hw, model_cfg["test"])
        pan, keep = fuse(seg_avg, dets, outs[0], model_cfg)
    n = len(dets["scores"])
    return {"seg_logits": seg_avg, **dets, "pan_map": pan, "pan_keep": keep[:n]}


def _det_gap(got: dict, want: dict) -> float:
    """How far the program's merged detections lie from the reference's:
    each one's nearest of its class (score gap plus coordinate gap over its
    longer side), the sorted scores rank by rank, and the mask logits of
    each against its nearest's as a relative L2."""
    gb, gs, gc = got["boxes"].double(), got["scores"].double(), got["classes"].long()
    wb, ws, wc = want["boxes"].double(), want["scores"].double(), want["classes"].long()
    if len(gb) != len(wb):
        return math.inf
    if not len(gb):
        return 0.0
    side = torch.maximum(gb[:, 2] - gb[:, 0], gb[:, 3] - gb[:, 1]).clamp(min=1.0)
    cost = ((gs[:, None] - ws[None]).abs() + (gb[:, None] - wb[None]).abs().amax(-1)
            / side[:, None])
    cost = torch.where(gc[:, None] == wc[None], cost, torch.full_like(cost, math.inf))
    best, near = cost.min(1)
    sorted_gap = float((torch.sort(gs, descending=True).values
                        - torch.sort(ws, descending=True).values).abs().max())
    if not bool(torch.isfinite(best).all()):
        return math.inf
    return max(float(best.max()), sorted_gap,
               rel(got["mask_logits"].float(), want["mask_logits"][near].float()))


def pan_gap(ref_seg_avg: torch.Tensor, got: dict, base: dict, model_cfg: dict) -> float:
    """The program's full-resolution panoptic map judged by the stack of the
    reference's merged logits and the program's detections, masks and keep
    flags, at the quarter scale the map was fused at."""
    test, num_stuff = model_cfg["test"], model_cfg["dataset"]["num_stuff"]
    dev = ref_seg_avg.device
    dets = {k: torch.as_tensor(got[k]).to(dev) for k in ("boxes", "scores", "classes",
                                                          "mask_logits")}
    dets["classes"] = dets["classes"].long()
    seg_q, pad = quarter_evidence(ref_seg_avg, dets, base, test["max_det"])
    keep = torch.zeros(test["max_det"], dtype=torch.bool, device=dev)
    got_keep = torch.as_tensor(got["pan_keep"]).bool().to(dev)
    if len(got_keep) > test["max_det"] or bool((got_keep & ~pad["valid"][:len(got_keep)]).any()):
        return math.inf
    keep[:len(got_keep)] = got_keep
    stack = panoptic_stack(seg_q, pad["boxes"], pad["classes"], pad["mask_logits"], keep,
                           num_stuff)
    pan = torch.as_tensor(got["pan_map"]).long().to(dev)
    oh, ow = ref_seg_avg.shape[:2]
    if tuple(pan.shape) != (oh, ow) or int(pan.min()) < 0 or int(pan.max()) >= stack.shape[0]:
        return math.inf
    cqh, cqw = content_q(base)
    iy = torch.clamp(torch.arange(oh, device=dev) * cqh // oh, max=cqh - 1)
    ix = torch.clamp(torch.arange(ow, device=dev) * cqw // ow, max=cqw - 1)
    qh, qw = stack.shape[1:]
    flat = stack.reshape(-1)
    cell = iy[:, None] * qw + ix[None, :]
    chosen = flat[pan * (qh * qw) + cell]
    best = stack.amax(0).reshape(-1)[cell]
    scale = float(seg_q[:cqh, :cqw].std())
    return float((best - chosen).max()) / scale


def judge_tta(ref_outs: list, prog_outs: list, prog: dict, model_cfg: dict) -> dict:
    """The TTA numbers of one frame. ``ref_outs``: the reference's variants
    (``run_variants``); ``prog_outs``: the program's variants, each with its
    ``flip``, ``target``, ``scale``, ``im_hw`` and numpy outputs; ``prog``:
    the program's merged seg_logits (oh, ow, C), its merged detections
    (boxes, scores, classes, mask_logits) and its pan_map and pan_keep."""
    want = [(v["target"], v["flip"]) for v in ref_outs]
    dev = ref_outs[0]["seg_logits"].device
    orig_hw = tuple(torch.as_tensor(prog["seg_logits"]).shape[:2])
    with torch.no_grad():
        ref_seg = merge_seg(ref_outs, orig_hw)
        out = {"tta_seg_err": rel(torch.as_tensor(prog["seg_logits"]).to(dev).float(), ref_seg)}
        if [(v["target"], v["flip"]) for v in prog_outs] != want:
            out["tta_det_err"] = math.inf
        else:
            redo = merge_detections(prog_outs, orig_hw, model_cfg["test"])
            got = {k: torch.as_tensor(prog[k]) for k in ("boxes", "scores", "classes",
                                                         "mask_logits")}
            out["tta_det_err"] = _det_gap(got, redo)
        out["tta_pan_gap"] = pan_gap(ref_seg, prog, ref_outs[0], model_cfg)
    return out
