"""UPSNet: full assembly, the training forward and the inference forward.

Port of ``upsnet_tpu/models/upsnet.py``. ``UPSNetModule`` holds the
parametered sub-networks. ``forward_predict`` runs the predict path over a
batch: dense trunk -> proposals + NMS -> box ROIAlign (K4) -> box head ->
joint class-offset detection NMS -> mask ROIAlign (K4) -> mask head ->
panoptic fusion; the FCN head's deformable convs run the sampling kernel
K1. ``forward_train`` returns the 7-term loss dict: the same trunk with the
all-tap sampler (K2, backward K3), anchor and RoI target assignment on the
device, ROIAlign through ``FPNRoIAlign`` (K4, backward K5) for the box
head, the fg mask head and the GT-box mask logits of the teacher-forced
panoptic loss. Under ``dcn_impl: shift`` the eligible levels sample through
the fused K8a instead, with K8b + K8c in backward (``ops/deform_shift.py``).
Shapes stay static: proposals padded to
``rpn_post_nms_top_n``, sampled RoIs to ``batch_rois``, detections to
``max_det``, GT to ``max_gt_instances``.

Public tensors keep the JAX package's layouts: images (B, H, W, 3) in,
``seg_logits`` (B, H/4, W/4, C) out. Inside, convs run NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn
from torch.profiler import record_function

from upsnet_torch.config.defaults import Config
from upsnet_torch.models import layers
from upsnet_torch.models.fcn import FCNHead
from upsnet_torch.models.fpn import FPN
from upsnet_torch.models.heads import BoxHead, MaskHead
from upsnet_torch.models.registry import register_model
from upsnet_torch.models.remat import run_checkpointed
from upsnet_torch.models.resnet import ResNetBackbone
from upsnet_torch.models.rpn import RPNHead
from upsnet_torch.ops import panoptic as pan_ops
from upsnet_torch.ops.anchors import FPN_STRIDES
from upsnet_torch.ops.boxes import clip_boxes, decode_boxes, fpn_level_assignment
from upsnet_torch.ops.mask_paste import paste_masks
from upsnet_torch.ops.nms import batched_class_nms
from upsnet_torch.ops.proposals import pyramid_proposals, top_k
from upsnet_torch.ops.roi_align_fpn import FPNRoIAlign
from upsnet_torch.ops.targets import proposal_mask_targets, rpn_targets
from upsnet_torch.train import losses as L
from upsnet_torch.utils.profiling import host_sync


class UPSNetModule(nn.Module):
    """Parametered sub-networks; parameter-free ops live in ops/."""

    def __init__(self, num_classes: int = 81, num_seg_classes: int = 133,
                 backbone: str = "resnet50", fpn_dim: int = 256,
                 num_anchors: int = 3, rcnn_fc_dim: int = 1024,
                 fcn_dim: int = 128, fcn_num_layers: int = 2,
                 fcn_with_dcn: bool = True, fcn_shared_subnet: bool = True,
                 dcn_impl: str = "auto", dcn_max_dy: int = 6,
                 pooled_size_box: int = 7, dtype=torch.float32,
                 dcn_boundary_grad: str = "clip", dcn_impl_train: str = "",
                 dcn_stages=(), norm: str = "frozen_bn"):
        super().__init__()
        # the backbone's DCN layers take the FCN head's train impl too: the
        # JAX train step clones the whole model with dcn_impl_train
        self.backbone_net = ResNetBackbone(backbone, dtype, norm, dcn_stages, dcn_impl,
                                           dcn_max_dy, dcn_boundary_grad, dcn_impl_train)
        self.fpn = FPN((256, 512, 1024, 2048), fpn_dim, dtype)
        self.rpn = RPNHead(num_anchors, fpn_dim, fpn_dim, dtype)
        self.box_head = BoxHead(num_classes, pooled_size_box ** 2 * fpn_dim,
                                rcnn_fc_dim, dtype)
        self.mask_head = MaskHead(num_classes, fpn_dim, dtype=dtype)
        self.fcn_head = FCNHead(num_seg_classes, fpn_dim, fcn_dim,
                                fcn_num_layers, fcn_with_dcn, fcn_shared_subnet,
                                dcn_impl, dcn_max_dy, dtype, dcn_boundary_grad,
                                dcn_impl_train)

    def extract(self, images):
        """Backbone + FPN + RPN + semantic head (the dense trunk).
        images (B, 3, H, W) -> (P2..P6 NCHW, RPN cls/bbox per level
        channel-last, semantic logits NCHW)."""
        pyramid = self.fpn(self.backbone_net(images))
        rpn_cls, rpn_bbox = self.rpn(pyramid)
        fcn_logits, _ = self.fcn_head(pyramid[:4])
        return pyramid, rpn_cls, rpn_bbox, fcn_logits


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every random parameter of ``model`` from ``generator``."""
    kinds = (layers.Conv2d, layers.Linear, layers.ConvTranspose2d,
             layers.DeformConv)
    for m in model.modules():
        if isinstance(m, kinds):
            m.reset_parameters(generator)


def freeze_stages(model: UPSNetModule, frozen_stages) -> None:
    """``requires_grad_(False)`` on the backbone's stem, conv1 and its norm
    (stage 1), and its res2 blocks (stage 2) when listed, as the reference
    freezes them. FrozenBN affines are buffers and never train; GroupNorm's
    are parameters and freeze with their stage."""
    prefixes = []
    if 1 in frozen_stages:
        prefixes += ["backbone_net.conv1.", "backbone_net.bn1."]
    if 2 in frozen_stages:
        prefixes.append("backbone_net.res2_")
    for name, p in model.named_parameters():
        if name.startswith(tuple(prefixes)):
            p.requires_grad_(False)


# The JAX package's ROIAlign forms: the TPU window kernel, the corner gather
# and the dense separable matmuls compute one function (its window kernel off
# the TPU is the gather), as K4 on the card and the plain version on the CPU.
ROI_ALIGN_IMPLS = ("window", "gather", "dense")


def build_model(cfg: Config, device=None,
                generator: torch.Generator | None = None) -> UPSNetModule:
    """The model of ``cfg`` in eval mode on ``device`` (CUDA unless the
    caller passes another device), initialised from ``generator`` (default:
    seeded with ``cfg.seed``), with ``cfg.network.frozen_stages`` frozen.
    Backbone DCN in ``dcn_stages`` where ``backbone_with_dcn`` is set; a
    ``norm`` or ``roi_align_impl`` it does not know is refused by name.
    Raises when no device is given and CUDA is not available. Turns TF32
    off: the JAX package computes its float32 convs and matmuls (DCN
    offsets, mask paste) in full float32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    net = cfg.network
    if net.norm not in layers.NORMS:
        raise ValueError(f"network.norm={net.norm!r}: expected one of {layers.NORMS}")
    if net.roi_align_impl not in ROI_ALIGN_IMPLS:
        raise ValueError(f"network.roi_align_impl={net.roi_align_impl!r}: expected one "
                         f"of {ROI_ALIGN_IMPLS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = UPSNetModule(
        num_classes=cfg.dataset.num_classes,
        num_seg_classes=cfg.dataset.num_seg_classes,
        backbone=net.backbone,
        fpn_dim=net.fpn_feature_dim,
        num_anchors=net.num_anchors,
        rcnn_fc_dim=net.rcnn_fc_dim,
        fcn_dim=net.fcn_head_dim,
        fcn_num_layers=net.fcn_num_layers,
        fcn_with_dcn=net.fcn_with_dcn,
        fcn_shared_subnet=net.fcn_shared_subnet,
        dcn_impl=net.dcn_impl,
        dcn_max_dy=net.dcn_max_dy,
        pooled_size_box=net.pooled_size_box,
        dtype=getattr(torch, net.compute_dtype),
        dcn_boundary_grad=net.dcn_boundary_grad,
        dcn_impl_train=net.dcn_impl_train,
        dcn_stages=tuple(net.dcn_stages) if net.backbone_with_dcn else (),
        norm=net.norm,
    )
    freeze_stages(model, net.frozen_stages)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    return model.to(device).eval()


@register_model("upsnet")
def upsnet_from_config(cfg: Config, **kw) -> UPSNetModule:
    """Generic symbol: backbone taken from cfg.network.backbone."""
    return build_model(cfg, **kw)


@register_model("resnet_50_upsnet")
def resnet_50_upsnet(cfg: Config, **kw) -> UPSNetModule:
    return build_model(cfg.replace(network=dataclasses.replace(
        cfg.network, backbone="resnet50")), **kw)


@register_model("resnet_101_upsnet")
def resnet_101_upsnet(cfg: Config, **kw) -> UPSNetModule:
    return build_model(cfg.replace(network=dataclasses.replace(
        cfg.network, backbone="resnet101")), **kw)


# ---------------------------------------------------------------------------
# inference forward
# ---------------------------------------------------------------------------


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4)
    scores: torch.Tensor  # (B, D)
    classes: torch.Tensor  # (B, D) int64, 1..C-1
    valid: torch.Tensor  # (B, D) bool


def _channel_last(pyramid):
    """P2..P5 (NCHW) as the contiguous (B, H, W, C) levels that
    ``_pool_boxes`` reads; made once per forward for all its calls, so
    autograd sums their gradients per level before the one permute back."""
    return tuple(p.permute(0, 2, 3, 1).contiguous() for p in pyramid[:4])


def _pool_boxes(levels4, rois, pooled: int, sampling_ratio: int = 2):
    """FPN ROIAlign of rois (B, R, 4) over the channel-last P2..P5 of
    ``_channel_last`` -> (B, R, P, P, C), differentiable in the levels only."""
    rois = rois.detach().contiguous()
    levels = (fpn_level_assignment(rois) - 2).to(torch.int32).contiguous()
    return FPNRoIAlign.apply(rois, levels, pooled, sampling_ratio,
                             FPN_STRIDES[:4], *levels4)


def _flatten_rpn(rpn_cls, rpn_bbox):
    """Per-level (B, H, W, A*k) -> (B, sum HWA, k), row-major (y, x, a) to
    match the anchor grid layout."""
    cls_flat = [c.reshape(c.shape[0], -1, 2) for c in rpn_cls]
    bbox_flat = [b.reshape(b.shape[0], -1, 4) for b in rpn_bbox]
    return torch.cat(cls_flat, 1), torch.cat(bbox_flat, 1)


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

NOISE_KEYS = ("rpn_fg", "rpn_bg", "roi_fg", "roi_bg", "unknown")

# the counts that normalise the loss terms, in the order ``forward_train``
# hands them to ``joined_counts``
COUNT_KEYS = ("rpn_valid", "rpn_norm", "roi_valid", "mask_fg", "seg_valid", "images")


def draw_noise(cfg: Config, batch_size: int, n_anchors: int, generator: torch.Generator,
               device) -> dict:
    """Every uniform draw that ``forward_train`` makes from ``generator`` for
    a batch of ``batch_size`` when no ``noise`` is passed, in its order and
    shapes: (B, anchors) twice, (B, proposals + G) twice, and (B, G) where
    the panoptic head runs."""
    tc, net = cfg.train, cfg.network
    n_cand = tc.rpn_post_nms_top_n + tc.max_gt_instances
    shapes = {"rpn_fg": n_anchors, "rpn_bg": n_anchors, "roi_fg": n_cand, "roi_bg": n_cand}
    if net.has_panoptic_head and net.has_fcn_head:
        shapes["unknown"] = tc.max_gt_instances
    return {k: torch.rand((batch_size, n), device=device, generator=generator)
            for k, n in shapes.items()}


def forward_train(model: UPSNetModule, cfg: Config, anchors, batch,
                  noise: dict | None = None,
                  generator: torch.Generator | None = None,
                  joined_counts=None):
    """One training forward pass. Returns (total_loss, loss_dict) with the
    keys rpn_cls, rpn_bbox, cls, bbox, mask, seg, pano.

    batch: images (B, H, W, 3), im_hw (B, 2), gt_boxes (B, G, 4), gt_classes
    (B, G), gt_valid (B, G), gt_masks (B, G, H/4, W/4), seg_gt (B, H/4, W/4);
    optional crowd_boxes (B, Gc, 4) and crowd_valid (B, Gc). anchors:
    per-level (N_l, 4) tensors on the model's device.

    Randomness enters through uniform [0, 1) draws only, each optional in
    ``noise``: ``rpn_fg``, ``rpn_bg`` (B, anchors) and ``roi_fg``, ``roi_bg``
    (B, proposals + G) sampling priorities, and ``unknown`` (B, G), which
    routes GT instance i to the unknown channel where it exceeds
    ``panoptic_box_keep_fraction``. Absent ones are drawn from ``generator``
    on the batch's device. Each stage runs inside a ``train.<stage>``
    profiler range. The trunk (``extract``) runs under ``train.remat`` and
    ``train.remat_policy`` as the JAX step runs it (``models/remat.py``).

    Each term divides by a count over the batch (``COUNT_KEYS``: sampled
    anchors, the RPN regression norm, sampled RoIs, fg mask RoIs, labelled
    pixels, images). ``joined_counts``, when given, maps those local counts
    (one float tensor, without grad) to the joined batch's: a data-parallel
    step all-reduces them, so that each rank's terms are its share of the
    joined batch's and their sum over the ranks is the joined batch's loss.
    """
    tc, net, ds = cfg.train, cfg.network, cfg.dataset
    noise = noise or {}
    unknown_keys = set(noise) - set(NOISE_KEYS)
    if unknown_keys:
        raise KeyError(f"unknown noise keys {sorted(unknown_keys)}")
    images = batch["images"]
    bsz = images.shape[0]
    dev = images.device
    im_hw = batch["im_hw"].float()
    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
    gt_classes = batch["gt_classes"]
    gcn = tc.max_crowd_instances
    crowd_boxes = batch.get("crowd_boxes")
    if crowd_boxes is None:
        crowd_boxes = torch.zeros((bsz, gcn, 4), device=dev)
    crowd_valid = batch.get("crowd_valid")
    if crowd_valid is None:
        crowd_valid = torch.zeros((bsz, gcn), dtype=torch.bool, device=dev)

    with record_function("train.trunk"):
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pyramid, rpn_cls, rpn_bbox, fcn_logits = run_checkpointed(
            model.extract, x, tc.remat, tc.remat_policy)
        cls_flat, bbox_flat = _flatten_rpn(rpn_cls, rpn_bbox)

    with record_function("train.targets"), torch.no_grad():
        rt = rpn_targets(
            torch.cat(list(anchors), dim=0), gt_boxes, gt_valid, im_hw,
            batch_size=tc.rpn_batch_size, fg_fraction=tc.rpn_fg_fraction,
            positive_overlap=tc.rpn_positive_overlap,
            negative_overlap=tc.rpn_negative_overlap,
            straddle_thresh=tc.rpn_straddle_thresh,
            crowd_boxes=crowd_boxes, crowd_valid=crowd_valid,
            crowd_thresh=tc.crowd_filter_thresh,
            pri_fg=noise.get("rpn_fg"), pri_bg=noise.get("rpn_bg"),
            generator=generator,
        )
        # proposals carry no gradient (the JAX stop_gradient)
        rois, _, roi_valid = pyramid_proposals(
            rpn_cls, rpn_bbox, anchors, im_hw,
            pre_nms_top_n=tc.rpn_pre_nms_top_n,
            post_nms_top_n=tc.rpn_post_nms_top_n,
            nms_thresh=tc.rpn_nms_thresh, min_size=tc.rpn_min_size,
        )
        tgt = proposal_mask_targets(
            rois, roi_valid, gt_boxes, gt_classes, gt_valid, batch["gt_masks"],
            batch_rois=tc.batch_rois, fg_fraction=tc.fg_fraction,
            fg_thresh=tc.fg_thresh, bg_thresh_hi=tc.bg_thresh_hi,
            bg_thresh_lo=tc.bg_thresh_lo,
            bbox_weights=tuple(net.bbox_reg_weights), mask_size=net.mask_size,
            mask_scale=0.25,  # gt_masks live at 1/4 scale
            crowd_boxes=crowd_boxes, crowd_valid=crowd_valid,
            crowd_thresh=tc.crowd_filter_thresh,
            pri_fg=noise.get("roi_fg"), pri_bg=noise.get("roi_bg"),
            generator=generator,
        )

    k_fg = int(tc.batch_rois * tc.fg_fraction)
    seg_gt = batch["seg_gt"].long()
    with torch.no_grad():
        sums = [(rt.labels >= 0).sum().float(), rt.norm.sum().float(), tgt.valid.sum().float(),
                tgt.fg[:, :k_fg].sum().float(), (seg_gt != L.IGNORE).sum().float()]
        with host_sync("const_h2d"):
            n_images_t = torch.tensor(float(bsz), device=dev)
        counts = torch.stack([*sums, n_images_t])
        if joined_counts is not None:
            counts = joined_counts(counts)
    n_rpn, rpn_norm, n_roi, n_fg, n_seg, n_images = counts.unbind()

    with record_function("train.rpn_loss"):
        loss_rpn_cls = L.rpn_cls_loss(cls_flat.reshape(-1, 2), rt.labels.reshape(-1), n_rpn)
        loss_rpn_bbox = L.rpn_bbox_loss(
            bbox_flat.reshape(-1, 4), rt.bbox_targets.reshape(-1, 4),
            rt.bbox_inside.reshape(-1), rpn_norm)

    with record_function("train.box_branch"):
        pb, r = net.pooled_size_box, tc.batch_rois
        levels4 = _channel_last(pyramid)
        pooled_box = _pool_boxes(levels4, tgt.rois, pb, net.roi_sampling_ratio)
        cls_score, bbox_pred = model.box_head(pooled_box.reshape(bsz * r, pb, pb, -1))
        loss_cls = L.rcnn_cls_loss(cls_score, tgt.labels.reshape(-1),
                                   tgt.valid.reshape(-1), n_roi)
        loss_bbox = L.rcnn_bbox_loss(
            bbox_pred, tgt.labels.reshape(-1), tgt.bbox_targets.reshape(-1, 4),
            tgt.fg.reshape(-1), tgt.valid.reshape(-1), count=n_roi)

    # mask head on the fg RoIs, which occupy the first k_fg slots
    with record_function("train.mask_branch"):
        pm, ms = net.pooled_size_mask, net.mask_size
        pooled_mask = _pool_boxes(levels4, tgt.rois[:, :k_fg], pm, net.roi_sampling_ratio)
        mask_logits = model.mask_head(pooled_mask.reshape(bsz * k_fg, pm, pm, -1))
        loss_mask = L.mask_loss(
            mask_logits, tgt.labels[:, :k_fg].reshape(-1),
            tgt.mask_targets[:, :k_fg].reshape(-1, ms, ms), tgt.fg[:, :k_fg].reshape(-1),
            n_fg)

    zero = torch.zeros((), device=dev)
    with record_function("train.seg_loss"):
        seg_logits = fcn_logits.permute(0, 2, 3, 1)  # (B, H/4, W/4, C)
        loss_seg = L.seg_loss(seg_logits, seg_gt, count=n_seg) if net.has_fcn_head else zero
        if net.has_fcn_head and tc.fcn_with_roi_loss:
            roi_seg = L.seg_roi_loss(seg_logits, seg_gt, gt_boxes * 0.25, gt_valid)
            loss_seg = loss_seg + tc.fcn_roi_loss_weight * (roi_seg.sum() / n_images)

    # panoptic head, teacher-forced: GT boxes and classes with the mask
    # head's logits for them; needs the semantic head
    with record_function("train.panoptic"):
        if net.has_panoptic_head and net.has_fcn_head:
            g = gt_boxes.shape[1]
            pooled_gt = _pool_boxes(levels4, gt_boxes, pm, net.roi_sampling_ratio)
            gt_mask_logits = model.mask_head(pooled_gt.reshape(bsz * g, pm, pm, -1))
            rows = torch.arange(bsz * g, device=dev)
            gt_chan = gt_mask_logits.float()[rows, gt_classes.reshape(-1).long()]
            gt_chan = gt_chan.reshape(bsz, g, ms, ms)
            draw = noise.get("unknown")
            if draw is None:
                draw = torch.rand((bsz, g), device=dev, generator=generator)
            to_unknown = draw > tc.panoptic_box_keep_fraction
            seg_f = seg_logits.float()
            per_image = []
            for i in range(bsz):
                pan_logits = pan_ops.panoptic_logits(
                    seg_f[i], gt_boxes[i] * 0.25, (gt_classes[i].long() - 1).clamp(min=0),
                    gt_chan[i], gt_valid[i] & ~to_unknown[i], ds.num_stuff)
                pan_gt = pan_ops.mask_matching(
                    seg_gt[i], batch["gt_masks"][i], gt_valid[i], to_unknown[i],
                    ds.num_stuff)
                per_image.append(L.panoptic_loss(pan_logits, pan_gt.long()))
            loss_pano = torch.stack(per_image).sum() / n_images
        else:
            loss_pano = zero

    losses = {
        "rpn_cls": loss_rpn_cls,
        "rpn_bbox": loss_rpn_bbox,
        "cls": loss_cls,
        "bbox": loss_bbox,
        "mask": loss_mask,
        "seg": loss_seg * tc.fcn_loss_weight,
        "pano": loss_pano * tc.panoptic_loss_weight,
    }
    return sum(losses.values()), losses


def _detection_nms(boxes_pc, scores_pc, cfg_test, num_classes: int) -> Detections:
    """Joint class-offset NMS + global top-k, batched over images.

    boxes_pc (B, R, C, 4) decoded per class; scores_pc (B, R, C). Classes
    are shifted apart so per-class NMS is one NMS; the score-ranked pool of
    ``detection_nms_pool`` candidates enters it and ``max_det`` leave.
    """
    b, rr = boxes_pc.shape[:2]
    nc = num_classes - 1  # classes 1..C-1 (skip background)
    boxes_f = boxes_pc[:, :, 1:].reshape(b, rr * nc, 4)
    scores_f = scores_pc[:, :, 1:].reshape(b, rr * nc)
    classes_f = torch.arange(1, num_classes, device=boxes_pc.device).repeat(rr)
    classes_f = classes_f.expand(b, rr * nc)
    sc = torch.where(scores_f >= cfg_test.score_thresh, scores_f,
                     torch.full_like(scores_f, float("-inf")))
    pool = min(getattr(cfg_test, "detection_nms_pool", 2048) or rr * nc, rr * nc)
    top_sc, top_i = top_k(sc, pool)
    idx, keep = batched_class_nms(
        torch.gather(boxes_f, 1, top_i[..., None].expand(b, pool, 4)), top_sc,
        torch.gather(classes_f, 1, top_i), cfg_test.nms_thresh,
        cfg_test.max_det, torch.isfinite(top_sc),
    )
    safe = torch.gather(top_i, 1, idx.clamp(min=0))
    d = safe.shape[1]
    return Detections(
        torch.gather(boxes_f, 1, safe[..., None].expand(b, d, 4)),
        torch.where(keep, torch.gather(scores_f, 1, safe),
                    torch.full(safe.shape, float("-inf"), device=safe.device)),
        torch.gather(classes_f, 1, safe),
        keep,
    )


def panoptic_fuse(seg_lg, boxes, classes, ms_logits, scores, valid, *,
                  score_thresh: float, overlap_thresh: float, num_stuff: int):
    """Panoptic fusion at 1/4 scale, batched: score filter -> MaskRemoval ->
    streaming argmax. seg_lg (B, H, W, C); boxes (B, D, 4) image coords;
    classes (B, D); ms_logits (B, D, M, M). Returns pan_map (B, H, W) int32
    and keep (B, D) bool."""
    seg_lg = seg_lg.float()
    b, d, m, _ = ms_logits.shape
    hw = (seg_lg.shape[1], seg_lg.shape[2])
    boxes_q = boxes * 0.25
    pasted = paste_masks(torch.sigmoid(ms_logits).reshape(b * d, m, m),
                         boxes_q.reshape(b * d, 4), hw).reshape(b, d, *hw)
    keep = pan_ops.mask_removal(pasted, valid & (scores >= score_thresh),
                                overlap_thresh)
    thing = (classes - 1).clamp(min=0)
    pan_map = torch.stack([
        pan_ops.panoptic_argmax_stream(seg_lg[i], boxes_q[i], thing[i],
                                       ms_logits[i], keep[i], num_stuff)
        for i in range(b)
    ])
    return pan_map, keep


@torch.no_grad()
def forward_predict(model: UPSNetModule, cfg: Config, anchors, batch) -> dict:
    """Inference over batch = {"images": (B, H, W, 3), "im_hw": (B, 2)};
    anchors: per-level (N_l, 4) tensors on the model's device. Returns the
    JAX package's padded outputs: boxes, scores, classes, det_valid,
    mask_logits, seg_logits, pan_map, pan_keep. Each stage runs inside a
    ``predict.<stage>`` profiler range (free when no profiler records)."""
    tc, net, ds = cfg.test, cfg.network, cfg.dataset
    images = batch["images"]
    im_hw = batch["im_hw"].float()
    bsz = images.shape[0]
    with record_function("predict.trunk"):
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        pyramid, rpn_cls, rpn_bbox, fcn_logits = model.extract(x)

    with record_function("predict.proposals"):
        rois, _, roi_valid = pyramid_proposals(
            rpn_cls, rpn_bbox, anchors, im_hw,
            pre_nms_top_n=tc.rpn_pre_nms_top_n,
            post_nms_top_n=tc.rpn_post_nms_top_n,
            nms_thresh=tc.rpn_nms_thresh,
        )
    with record_function("predict.box_branch"):
        pb = net.pooled_size_box
        levels4 = _channel_last(pyramid)
        pooled_box = _pool_boxes(levels4, rois, pb, net.roi_sampling_ratio)
        r = rois.shape[1]
        cls_score, bbox_pred = model.box_head(pooled_box.reshape(bsz * r, pb, pb, -1))
        c = cls_score.shape[-1]
        scores = torch.softmax(cls_score.float(), -1).reshape(bsz, r, c)
        deltas = bbox_pred.float().reshape(bsz, r, c, 4)
        boxes_pc = clip_boxes(
            decode_boxes(rois[:, :, None, :], deltas, tuple(net.bbox_reg_weights)),
            im_hw)
        scores = torch.where(roi_valid[..., None], scores, torch.zeros_like(scores))
    with record_function("predict.detection_nms"):
        dets = _detection_nms(boxes_pc, scores, tc, c)

    with record_function("predict.mask_branch"):
        pm = net.pooled_size_mask
        pooled_mask = _pool_boxes(levels4, dets.boxes, pm, net.roi_sampling_ratio)
        d = dets.boxes.shape[1]
        mask_all = model.mask_head(pooled_mask.reshape(bsz * d, pm, pm, -1)).float()
        rows = torch.arange(bsz * d, device=mask_all.device)
        mask_logits = mask_all[rows, dets.classes.reshape(-1)].reshape(
            bsz, d, net.mask_size, net.mask_size)

    with record_function("predict.panoptic"):
        seg_logits = fcn_logits.float().permute(0, 2, 3, 1).contiguous()
        pan_map, pan_keep = panoptic_fuse(
            seg_logits, dets.boxes, dets.classes, mask_logits, dets.scores,
            dets.valid, score_thresh=tc.panoptic_score_thresh,
            overlap_thresh=tc.panoptic_mask_overlap_thresh,
            num_stuff=ds.num_stuff,
        )
    return {
        "boxes": dets.boxes,
        "scores": dets.scores,
        "classes": dets.classes.to(torch.int32),
        "det_valid": dets.valid,
        "mask_logits": mask_logits,
        "seg_logits": seg_logits,
        "pan_map": pan_map,  # (B, H/4, W/4) channel indices
        "pan_keep": pan_keep,  # (B, D) detections present in pan_map
    }
