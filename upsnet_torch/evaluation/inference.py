"""End-to-end evaluation loop (the reference's test entry, SURVEY.md §3.2).

The port's copy of ``upsnet_tpu/evaluation/inference.py``. ``run_evaluation``
runs ``predict_step`` (``forward_predict`` with the semantic argmax taken on
the device) over a dataset, one image a forward, maps the padded outputs
back to original-image coordinates on the host, and feeds the four
evaluators: boxes (AP), masks (AP), semantic (mIoU), panoptic (PQ).

Host work is the JAX package's, in numpy and cv2 on the same values:
coordinate unscaling, the mask probabilities as ``1 / (1 + np.exp(-x))`` in
float32, the full-resolution mask paste and its 0.5 threshold, RLE encode,
nearest-resize of the 1/4-scale semantic and panoptic maps, and panoptic
segment bookkeeping. A sigmoid on the device would round otherwise and flip
pixels at the threshold, so only the logits cross.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from upsnet_torch.config.defaults import Config
from upsnet_torch.evaluation import rle as rle_mod
from upsnet_torch.evaluation import rle_native
from upsnet_torch.evaluation.panoptic_format import build_panoptic_output, write_panoptic_results
from upsnet_torch.evaluation.tta import predict_image_tta, tta_variants
from upsnet_torch.models.registry import get_model
from upsnet_torch.models.upsnet import forward_predict
from upsnet_torch.ops.anchors import pyramid_anchors
from upsnet_torch.parallel.mesh import Group
from upsnet_torch.train.checkpoints import restore_checkpoint

# seg_pred_q is uint8, as the JAX predict step's
MAX_SEG_CLASSES = 256


def paste_mask_full(mask_prob: np.ndarray, box: np.ndarray, hw) -> np.ndarray:
    """Host-side Detectron-style paste: resize M x M probs to the box size,
    threshold at 0.5 into a full-resolution canvas."""
    import cv2

    h, w = hw
    x1, y1, x2, y2 = box
    x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
    x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
    bw = max(x2i - x1i + 1, 1)
    bh = max(y2i - y1i + 1, 1)
    m = cv2.resize(mask_prob, (bw, bh), interpolation=cv2.INTER_LINEAR)
    out = np.zeros((h, w), np.uint8)
    xs0, ys0 = max(x1i, 0), max(y1i, 0)
    xs1, ys1 = min(x2i + 1, w), min(y2i + 1, h)
    if xs1 > xs0 and ys1 > ys0:
        out[ys0:ys1, xs0:xs1] = (
            m[ys0 - y1i : ys1 - y1i, xs0 - x1i : xs1 - x1i] >= 0.5
        ).astype(np.uint8)
    return out


def _category_tables(cfg: Config, dataset):
    """(num_stuff, stuff channel -> cat id, det label -> cat id)."""
    if hasattr(dataset, "label_to_thing_cat"):
        stuff_ids = dataset.stuff_cat_ids
        return len(stuff_ids), stuff_ids, dataset.label_to_thing_cat
    num_stuff = cfg.dataset.num_stuff
    thing_ids = {i: num_stuff + i - 1 for i in range(cfg.dataset.num_classes)}
    return num_stuff, list(range(num_stuff)), thing_ids


def _summarize(dataset, all_dets, all_segs, all_pans) -> dict:
    results = {}
    try:
        results["boxes"] = dataset.evaluate_boxes(all_dets)
        results["masks"] = dataset.evaluate_masks(all_dets)
    except NotImplementedError:
        pass
    try:
        results["ssegs"] = dataset.evaluate_ssegs(all_segs)
        results["panoptic"] = dataset.evaluate_panoptic(all_pans)
    except NotImplementedError:
        pass
    return results


def postprocess_image(cfg: Config, dataset, out_i: dict, meta: dict):
    """Predict-step outputs for one image (numpy) -> detection / seg /
    panoptic results in original-image coordinates."""
    import cv2

    scale = float(meta["scale"])
    oh, ow = (int(x) for x in meta["orig_hw"])
    rh, rw = (int(x) for x in meta["im_hw"])
    image_id = meta["image_id"]

    valid = np.asarray(out_i["det_valid"])
    boxes = np.asarray(out_i["boxes"])[valid] / scale
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, ow - 1)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, oh - 1)
    scores = np.asarray(out_i["scores"])[valid]
    classes = np.asarray(out_i["classes"])[valid]
    mask_probs = 1.0 / (1.0 + np.exp(-np.asarray(out_i["mask_logits"])[valid]))

    detections = []
    for b, s, c, m in zip(boxes, scores, classes, mask_probs):
        det = {
            "image_id": image_id,
            "category": int(c),
            "score": float(s),
            "bbox": b.tolist(),
        }
        det["segmentation"] = rle_mod.encode(paste_mask_full(m, b, (oh, ow)))
        detections.append(det)

    # semantic prediction: argmax at 1/4 canvas scale (on the device, in
    # predict_step) -> crop -> orig size
    seg_pred_q = np.asarray(out_i["seg_pred_q"])
    seg_pred_q = seg_pred_q[: max(rh // 4, 1), : max(rw // 4, 1)]
    seg_pred = cv2.resize(
        seg_pred_q.astype(np.int32), (ow, oh), interpolation=cv2.INTER_NEAREST
    )

    # panoptic: channel map -> segments at original resolution
    pan_q = np.asarray(out_i["pan_map"])[: max(rh // 4, 1), : max(rw // 4, 1)]
    pan_full = cv2.resize(
        pan_q.astype(np.int32), (ow, oh), interpolation=cv2.INTER_NEAREST
    )
    det_classes_all = np.asarray(out_i["classes"])
    det_keep = np.asarray(out_i["pan_keep"])
    num_stuff, stuff_cat_ids, thing_cat_ids = _category_tables(cfg, dataset)
    # area limit applies at original resolution
    id_map, segments = build_panoptic_output(
        pan_full, num_stuff, det_classes_all, det_keep,
        cfg.test.panoptic_stuff_area_limit, stuff_cat_ids, thing_cat_ids,
    )
    return {
        "detections": detections,
        "seg": {"image_id": image_id, "pred": seg_pred},
        "panoptic": {"image_id": image_id, "id_map": id_map, "segments": segments},
    }


def bucket_anchors(cfg: Config, bucket, device) -> tuple:
    """The anchors of a ``bucket`` canvas, per level, on ``device``, with the
    configuration's ``anchor_scale`` and ``anchor_ratios``."""
    net = cfg.network
    return tuple(torch.as_tensor(a, device=device) for a in pyramid_anchors(
        tuple(bucket), ratios=tuple(net.anchor_ratios), scale=net.anchor_scale))


@torch.no_grad()
def predict_step(model, cfg: Config, anchors, batch, seg_argmax: bool = True) -> dict:
    """``forward_predict`` with the JAX predict step's ``seg_argmax``
    (``upsnet_tpu/parallel/steps.py:make_predict_step``): ``seg_logits`` is
    replaced by ``seg_pred_q``, its uint8 argmax over the classes, taken on
    the device (``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` does), so that the full logits never cross to the host.
    With ``seg_argmax`` False (test-time augmentation, which averages them)
    the float32 ``seg_logits`` cross instead. Every output comes back as a
    numpy array; the argmax and the copies run inside a ``predict.to_host``
    profiler range, after ``forward_predict``'s ``predict.<stage>`` ranges."""
    out = forward_predict(model, cfg, anchors, batch)
    with record_function("predict.to_host"):
        if seg_argmax:
            seg = out.pop("seg_logits")
            if seg.shape[-1] > MAX_SEG_CLASSES:
                raise ValueError(f"{seg.shape[-1]} semantic classes do not fit "
                                 "seg_pred_q's uint8")
            out["seg_pred_q"] = torch.argmax(seg, dim=-1).to(torch.uint8)
        return {k: v.cpu().numpy() for k, v in out.items()}


def tta_results(cfg: Config, dataset, r: dict) -> dict:
    """``predict_image_tta``'s merged outputs for one image -> detection /
    seg / panoptic results, as ``postprocess_image`` gives them (the JAX
    ``run_evaluation``'s TTA branch)."""
    oh, ow = r["orig_hw"]
    detections = []
    for b, s_, c, m in zip(r["boxes"], r["scores"], r["classes"], r["mask_logits"]):
        mp = 1.0 / (1.0 + np.exp(-m))
        detections.append({
            "image_id": r["image_id"], "category": int(c),
            "score": float(s_), "bbox": b.tolist(),
            "segmentation": rle_mod.encode(paste_mask_full(mp, b, (oh, ow))),
        })
    num_stuff, stuff_ids, thing_ids = _category_tables(cfg, dataset)
    id_map, segments = build_panoptic_output(
        r["pan_map"], num_stuff, r["classes"], r["pan_keep"],
        cfg.test.panoptic_stuff_area_limit, stuff_ids, thing_ids,
    )
    return {
        "detections": detections,
        "seg": {"image_id": r["image_id"], "pred": r["seg_pred"]},
        "panoptic": {"image_id": r["image_id"], "id_map": id_map, "segments": segments},
    }


def run_evaluation(cfg: Config, dataset, weights=None, logger=None,
                   max_images=None, model=None, output_dir=None, device=None,
                   timings: dict | None = None, group: Group | None = None) -> dict:
    """Predict and evaluate the first ``max_images`` images of ``dataset``
    (all by default). ``model``, a built model, takes the place of the JAX
    function's ``params``; by default the registry builds ``cfg.symbol`` on ``device``
    (CUDA unless the caller passes another device) and ``weights``, a port
    checkpoint, is restored into it. Returns the evaluators' results by name
    (boxes, masks, ssegs, panoptic). Where ``timings`` is given it is filled
    with the wall-clock split: images and detections, seconds building samples, in
    ``predict_step`` (host to device, the forward, device to host),
    postprocessing on the host and in the evaluators, and the RLE codec;
    under TTA also the seconds merging the variants and fusing.

    Test-time augmentation (``test.multi_scale``, ``test.flip_test``) runs
    ``evaluation/tta.py:predict_image_tta`` per image, with the full float32
    semantic logits on the way to the host (the JAX ``seg_argmax=not
    use_tta``).

    Under a process group (``group``; the model then lives on the group's
    device) rank r predicts images ``r::world``, the JAX shard; the
    per-image results are gathered to rank 0 in image order and rank 0
    runs the evaluators and writes the artifacts, so the metrics equal one
    process's. Every rank returns rank 0's results; ``timings`` are the
    rank's own."""
    group = group or Group()
    use_tta = bool(cfg.test.multi_scale) or cfg.test.flip_test
    if model is None:
        model = get_model(cfg.symbol, cfg, device=group.device if group.distributed else device)
        if weights:
            restore_checkpoint(weights, model, partial=True)
    dev = next(model.parameters()).device
    anchors_by_bucket = {tuple(b): bucket_anchors(cfg, b, dev) for b in cfg.test.image_buckets}
    # bit-identical downstream (the stem casts to bf16 anyway) at half the
    # host->device bytes
    image_dtype = torch.bfloat16 if cfg.network.compute_dtype == "bfloat16" else torch.float32

    def predict(bucket, s, seg_argmax=True):
        batch = {
            "images": torch.from_numpy(s["images"][None]).to(image_dtype).to(dev),
            "im_hw": torch.from_numpy(s["im_hw"][None]).to(dev),
        }
        out = predict_step(model, cfg, anchors_by_bucket[bucket], batch, seg_argmax)
        return {k: v[0] for k, v in out.items()}

    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    clock = dict.fromkeys(("sample_s", "predict_s", "postprocess_s"), 0.0)
    per_image = []
    t_start = time.perf_counter()
    for done, i in enumerate(range(group.rank, n, group.world), start=1):
        if use_tta:
            r = predict_image_tta(cfg, dataset, i, lambda b, s: predict(b, s, False), dev,
                                  clock)
            t2 = time.perf_counter()
            res = tta_results(cfg, dataset, r)
        else:
            t0 = time.perf_counter()
            s = dataset.sample(i)
            t1 = time.perf_counter()
            out = predict(tuple(s["images"].shape[:2]), s)
            t2 = time.perf_counter()
            res = postprocess_image(cfg, dataset, out, s)
            clock["sample_s"] += t1 - t0
            clock["predict_s"] += t2 - t1
        per_image.append((i, res))
        clock["postprocess_s"] += time.perf_counter() - t2
        if logger and done % 50 == 0:
            logger.info("inference %d/%d", done * group.world, n)

    gathered = group.gather_to_main(per_image)
    results, n_dets, t0 = None, 0, time.perf_counter()
    if group.is_main:
        all_dets, all_segs, all_pans = [], [], []
        for _, res in sorted((r for rank in gathered for r in rank), key=lambda r: r[0]):
            all_dets.extend(res["detections"])
            all_segs.append(res["seg"])
            all_pans.append(res["panoptic"])
        n_dets = len(all_dets)
        _write_artifacts(output_dir, all_pans, logger)
        t0 = time.perf_counter()
        results = _summarize(dataset, all_dets, all_segs, all_pans)
    clock["evaluate_s"] = time.perf_counter() - t0
    results = group.broadcast_from_main(results)
    clock.update(images=len(per_image), detections=sum(len(r["detections"]) for _, r in per_image),
                 wall_s=time.perf_counter() - t_start, rle_codec=rle_native.codec(),
                 device=str(dev))
    if logger:
        per = 1e3 / max(len(per_image), 1)
        logger.info("%d images (%d detections) on %s%s: sample %.2f ms, predict %.2f ms, "
                    "postprocess %.2f ms an image; evaluators %.3f s; wall %.3f s; RLE codec %s",
                    clock["images"], clock["detections"], dev,
                    f" (rank {group.rank} of {group.world}; {n} in all, {n_dets} detections)"
                    if group.distributed else "",
                    clock["sample_s"] * per, clock["predict_s"] * per,
                    clock["postprocess_s"] * per, clock["evaluate_s"], clock["wall_s"],
                    clock["rle_codec"])
        if use_tta:
            logger.info("TTA, %d variants an image: merge %.2f ms, fusion %.2f ms an image",
                        len(tta_variants(cfg)), clock["merge_s"] * per, clock["fuse_s"] * per)
    if timings is not None:
        timings.update(clock)
    return results


def _write_artifacts(output_dir, all_pans, logger=None):
    """COCO-panoptic PNG + segments JSON under output_dir (the reference's
    evaluate_panoptic output layout, SURVEY.md §3.2/§3.4 step 5)."""
    if not output_dir or not all_pans:
        return
    json_path = write_panoptic_results(output_dir, all_pans)
    if logger:
        logger.info("wrote %d panoptic PNGs + %s", len(all_pans), json_path)
