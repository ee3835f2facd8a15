"""Plain float32 UPSNet training step: targets, the seven losses, gradients
and the SGD update, for judging the program's first training steps.

Written from the paper and the Detectron conventions that UPSNet trains
with. Anchor targets: anchors inside the image, fg at IoU >= 0.7 or the
best anchor of a GT (ties included), bg at IoU < 0.3, ``rpn_batch_size``
sampled at most half fg. RoI targets: the GT boxes appended to the
proposals, fg at IoU >= 0.5, ``batch_rois`` sampled at a quarter fg, box
deltas with weights (10, 10, 5, 5), 28x28 mask targets cropped bilinearly
from the 1/4-scale GT masks at the RoIAlign sample points, averaged 2x2 and
cut at 0.5. Sampling takes, among the eligible, those of highest priority;
the priorities are uniform draws that the benchmark makes and hands to both
sides. Losses: two-way softmax CE and smooth-L1 (beta 1/9) for the RPN,
softmax CE and class-specific smooth-L1 (beta 1) for the box head, sigmoid
BCE on the GT class for the mask head, softmax CE with 255 ignored for the
semantic head plus its RoI-cropped term, and the panoptic head's CE over
stuff, GT instances (teacher-forced, GT boxes and classes with the mask
head's logits) and the unknown channel, each normalised by its count over
the batch. The update: gradients clipped to the global norm ``grad_clip``,
weight decay added before momentum SGD, biases at twice the rate without
decay, the learning rate warmed up linearly.

The proposals are the program's own (the RPN's top-k and NMS reorder
near-equal candidates under any rounding); ``compare.py`` checks them
against the program's RPN outputs on their own. Each image runs forward and
backward on its own, the losses divided by the batch's counts, so that the
gradients add up to the batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.upsnet_ref import (
    Ref, STRIDES, box_window, iou, level_anchors, paste)

IGNORE = 255
LOSS_KEYS = ("rpn_cls", "rpn_bbox", "cls", "bbox", "mask", "seg", "pano")


def encode(boxes, gt, weights=(1.0, 1.0, 1.0, 1.0)):
    w = boxes[..., 2] - boxes[..., 0] + 1
    h = boxes[..., 3] - boxes[..., 1] + 1
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    gw = gt[..., 2] - gt[..., 0] + 1
    gh = gt[..., 3] - gt[..., 1] + 1
    gx, gy = gt[..., 0] + 0.5 * gw, gt[..., 1] + 0.5 * gh
    w, h = w.clamp(min=1e-6), h.clamp(min=1e-6)
    return torch.stack([weights[0] * (gx - cx) / w, weights[1] * (gy - cy) / h,
                        weights[2] * torch.log(gw.clamp(min=1e-6) / w),
                        weights[3] * torch.log(gh.clamp(min=1e-6) / h)], -1)


def sample(pri, eligible, k: int):
    """The (up to) k eligible positions of highest priority, best first,
    ties to the lower index: (indices (k,), valid (k,))."""
    pri = torch.where(eligible, pri, torch.full_like(pri, -1.0))
    order = torch.sort(-pri, stable=True).indices[:k]
    idx = torch.zeros(k, dtype=torch.long, device=pri.device)
    ok = torch.zeros(k, dtype=torch.bool, device=pri.device)
    idx[:len(order)] = order
    ok[:len(order)] = pri[order] >= 0
    return idx, ok


def anchor_targets(anchors, gt, gt_valid, im_hw, tc, pri_fg, pri_bg):
    """labels (N,) 1 fg / 0 bg / -1 ignore, deltas (N, 4), fg weights."""
    h, w = float(im_hw[0]), float(im_hw[1])
    inside = (anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) & (anchors[:, 2] < w) & (anchors[:, 3] < h)
    ov = torch.where(gt_valid[None], iou(anchors, gt), torch.zeros(()).to(anchors.device))
    best, arg = ov.max(1)
    gt_best = ov.amax(0, keepdim=True)
    is_best = ((ov == gt_best) & (gt_best > 0) & gt_valid[None]).any(1)
    fg = inside & ((best >= tc["rpn_positive_overlap"]) | is_best)
    bg = inside & (best < tc["rpn_negative_overlap"]) & ~fg
    k_fg = int(tc["rpn_batch_size"] * tc["rpn_fg_fraction"])
    fg_idx, fg_ok = sample(pri_fg, fg, k_fg)
    bg_idx, bg_ok = sample(pri_bg, bg, tc["rpn_batch_size"])
    n_fg = int(fg_ok.sum())
    bg_take = bg_ok & (torch.cumsum(bg_ok.long(), 0) - 1 < tc["rpn_batch_size"] - n_fg)
    labels = torch.full((len(anchors),), -1, dtype=torch.long, device=anchors.device)
    labels[bg_idx[bg_take]] = 0
    labels[fg_idx[fg_ok]] = 1
    return labels, encode(anchors, gt[arg])


def roi_targets(rois, roi_valid, gt, gt_cls, gt_valid, gt_masks, tc, net, pri_fg, pri_bg):
    """The sampled RoIs (R, 4), their validity, labels, fg flags, box
    targets and (for the first k_fg) 28x28 mask targets."""
    cand = torch.cat([rois, gt])
    cand_valid = torch.cat([roi_valid, gt_valid])
    ov = iou(cand, gt)
    ov = torch.where(gt_valid[None] & cand_valid[:, None], ov, torch.zeros_like(ov))
    best, arg = ov.max(1)
    fg = cand_valid & (best >= tc["fg_thresh"])
    bg = cand_valid & (best < tc["bg_thresh_hi"]) & (best >= tc["bg_thresh_lo"])
    r = tc["batch_rois"]
    k_fg = int(r * tc["fg_fraction"])
    fg_idx, fg_ok = sample(pri_fg, fg, k_fg)
    bg_idx, bg_ok = sample(pri_bg, bg, r)
    n_fg = int(fg_ok.sum())
    bg_take = bg_ok & (torch.cumsum(bg_ok.long(), 0) - 1 < r - n_fg)
    idx = torch.cat([fg_idx, bg_idx[:r - k_fg]])
    is_fg = torch.cat([fg_ok, torch.zeros(r - k_fg, dtype=torch.bool, device=rois.device)])
    valid = torch.cat([fg_ok, bg_take[:r - k_fg]])
    sel, m = cand[idx], arg[idx]
    labels = torch.where(is_fg, gt_cls.long()[m], torch.zeros_like(m))
    deltas = encode(sel, gt[m], net["bbox_reg_weights"])
    masks = mask_targets(sel[:k_fg] * 0.25, gt_masks[m[:k_fg]].float(), net["mask_size"])
    return sel, valid, labels, is_fg, deltas, masks


def mask_targets(boxes, masks, size: int, s: int = 2):
    """Each box's GT mask sampled at size x size bins of s x s points (the
    RoIAlign rule: no half-pixel shift, extent at least 1), bilinear with the
    Detectron clamp, averaged per bin, cut at 0.5."""
    n, hm, wm = masks.shape
    frac = (torch.arange(size, device=boxes.device, dtype=torch.float32)[:, None]
            + (torch.arange(s, device=boxes.device, dtype=torch.float32)[None] + 0.5) / s)
    rw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1.0)
    rh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1.0)
    ys = (boxes[:, 1, None, None] + frac[None] * (rh / size)[:, None, None]).reshape(n, -1)
    xs = (boxes[:, 0, None, None] + frac[None] * (rw / size)[:, None, None]).reshape(n, -1)

    def hat(c, length):
        inside = (c >= -1.0) & (c <= length)
        c = c.clamp(0.0, length - 1.0)
        k = (1 - (c[..., None] - torch.arange(length, device=c.device)).abs()).clamp(min=0)
        return k * inside[..., None]

    crops = hat(ys, hm) @ masks @ hat(xs, wm).transpose(1, 2)
    crops = crops.reshape(n, size, s, size, s).mean(dim=(2, 4))
    return (crops >= 0.5).float()


def smooth_l1(d, beta):
    d = d.abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def ce_sum(logits, labels, valid):
    ll = F.log_softmax(logits.float(), -1).gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return -(ll * valid).sum()


def seg_roi(seg_hwc, seg_gt, boxes_q, valid, crop: int = 28):
    """Semantic CE over 28x28 nearest samples inside each GT box, averaged
    over the valid samples of the image."""
    h, w = seg_gt.shape
    steps = (torch.arange(crop, device=seg_hwc.device, dtype=torch.float32) + 0.5) / crop
    bw = (boxes_q[:, 2] - boxes_q[:, 0] + 1).clamp(min=1)
    bh = (boxes_q[:, 3] - boxes_q[:, 1] + 1).clamp(min=1)
    yi = torch.round(boxes_q[:, 1, None] + steps * bh[:, None] - 0.5).clamp(0, h - 1).long()
    xi = torch.round(boxes_q[:, 0, None] + steps * bw[:, None] - 0.5).clamp(0, w - 1).long()
    lg = seg_hwc[yi[:, :, None], xi[:, None, :]]  # (G, m, m, C)
    gt = seg_gt[yi[:, :, None], xi[:, None, :]]
    ok = (gt != IGNORE) & valid[:, None, None]
    return ce_sum(lg, torch.where(ok, gt, torch.zeros_like(gt)), ok) / ok.sum().clamp(min=1)


def pan_gt(seg_gt, gt_masks, gt_valid, unknown, num_stuff):
    g = len(gt_valid)
    out = torch.where((seg_gt < num_stuff) & (seg_gt != IGNORE), seg_gt,
                      torch.full_like(seg_gt, IGNORE))
    for i in range(g):  # later instances overwrite earlier ones
        if bool(gt_valid[i]):
            chan = num_stuff + g if bool(unknown[i]) else num_stuff + i
            out = torch.where(gt_masks[i] > 0, torch.full_like(out, chan), out)
    return out


class TrainRef:
    """Three steps of training, in float32, from the state dict ``sd``."""

    def __init__(self, cfg: dict, sd: dict, fp8: bool = False):
        self.tc, self.net, self.ds = cfg["train"], cfg["network"], cfg["dataset"]
        self.params = {k: v.clone().requires_grad_(trainable(k, self.net)) for k, v in sd.items()}
        self.ref = Ref(cfg, self.params, fp8=fp8)
        self.ref.dcn_impl = self.net["dcn_impl_train"] or self.net["dcn_impl"]
        self.buf, self.count, self.grad_norms = {}, 0, {}

    def image_losses(self, image, im_hw, gt, tg, counts, noise_u):
        """The seven terms of one image, each its share of the batch's."""
        ref, tc, net, ds = self.ref, self.tc, self.net, self.ds
        pyramid, cls, bbox, seg = ref.trunk(image)
        cls_flat = torch.cat([c[0].reshape(-1, 2) for c in cls])
        bbox_flat = torch.cat([b[0].reshape(-1, 4) for b in bbox])
        lab, deltas = tg["rpn_labels"], tg["rpn_deltas"]
        out = {"rpn_cls": ce_sum(cls_flat, lab, lab >= 0) / counts["rpn"],
               "rpn_bbox": (smooth_l1(bbox_flat - deltas, 1 / 9).sum(-1) * (lab == 1)).sum()
               / counts["rpn_norm"]}
        rois, valid, labels, is_fg = tg["rois"], tg["roi_valid"], tg["labels"], tg["fg"]
        box_cls, box_bbox = ref.box_head(ref.roi_align(pyramid, rois, net["pooled_size_box"]))
        out["cls"] = ce_sum(box_cls, labels, valid) / counts["roi"]
        sel = box_bbox.reshape(len(rois), -1, 4)[torch.arange(len(rois)), labels]
        out["bbox"] = (smooth_l1(sel - tg["deltas"], 1.0).sum(-1) * is_fg).sum() / counts["roi"]
        k_fg = len(tg["mask_targets"])
        mk = ref.mask_head(ref.roi_align(pyramid, rois[:k_fg], net["pooled_size_mask"]))
        x = mk[torch.arange(k_fg), labels[:k_fg]]
        t = tg["mask_targets"]
        bce = (x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean(dim=(1, 2))
        out["mask"] = (bce * is_fg[:k_fg]).sum() / counts["fg"]
        seg_hwc = seg.permute(1, 2, 0)
        sg = gt["seg_gt"].long()
        ok = sg != IGNORE
        loss_seg = ce_sum(seg_hwc, torch.where(ok, sg, torch.zeros_like(sg)), ok) / counts["seg"]
        if tc["fcn_with_roi_loss"]:
            loss_seg = loss_seg + tc["fcn_roi_loss_weight"] * seg_roi(
                seg_hwc, sg, gt["boxes"] * 0.25, gt["valid"]) / counts["images"]
        out["seg"] = loss_seg * tc["fcn_loss_weight"]
        # panoptic head, teacher-forced on the GT
        g = len(gt["valid"])
        gm = ref.mask_head(ref.roi_align(pyramid, gt["boxes"], net["pooled_size_mask"]))
        gm = gm[torch.arange(g), gt["classes"].long()]
        unknown = noise_u > tc["panoptic_box_keep_fraction"]
        keep = gt["valid"] & ~unknown
        bq = gt["boxes"] * 0.25
        hw = seg_hwc.shape[:2]
        stuff = seg_hwc[..., :ds["num_stuff"]].permute(2, 0, 1)
        things = seg_hwc[..., ds["num_stuff"]:].permute(2, 0, 1)
        seg_t = things[(gt["classes"].long() - 1).clamp(min=0)] * box_window(bq, hw)
        inst = torch.where(keep[:, None, None], seg_t + paste(gm, bq, hw),
                           torch.full_like(seg_t, -1e4))
        inst_max = torch.where(keep[:, None, None], seg_t, torch.full_like(seg_t, -1e4)).amax(0)
        if not bool(keep.any()):
            inst_max = torch.zeros_like(inst_max)
        stack = torch.cat([stuff, inst, (things.amax(0) - inst_max)[None]]).permute(1, 2, 0)
        pg = pan_gt(sg, gt["masks"], gt["valid"], unknown, ds["num_stuff"]).long()
        okp = pg != IGNORE
        out["pano"] = (ce_sum(stack, torch.where(okp, pg, torch.zeros_like(pg)), okp)
                       / okp.sum().clamp(min=1) / counts["images"] * tc["panoptic_loss_weight"])
        return out

    def targets(self, batch, rois, roi_valid, noise):
        """Every image's targets and the batch's counts."""
        anchors = torch.cat([level_anchors(-(-batch["images"].shape[1] // s),
                                           -(-batch["images"].shape[2] // s), s,
                                           self.net["anchor_ratios"], self.net["anchor_scale"])
                             for s in STRIDES]).to(rois.device)
        tgs, counts = [], dict.fromkeys(("rpn", "rpn_norm", "roi", "fg", "seg"), 0.0)
        for i in range(len(rois)):
            gt_valid = batch["gt_valid"][i].bool()
            lab, deltas = anchor_targets(anchors, batch["gt_boxes"][i], gt_valid,
                                         batch["im_hw"][i], self.tc, noise["rpn_fg"][i],
                                         noise["rpn_bg"][i])
            sel, valid, labels, is_fg, d, m = roi_targets(
                rois[i], roi_valid[i], batch["gt_boxes"][i], batch["gt_classes"][i], gt_valid,
                batch["gt_masks"][i], self.tc, self.net, noise["roi_fg"][i], noise["roi_bg"][i])
            tgs.append({"rpn_labels": lab, "rpn_deltas": deltas, "rois": sel, "roi_valid": valid,
                        "labels": labels, "fg": is_fg, "deltas": d, "mask_targets": m})
            n = float((lab >= 0).sum())
            counts["rpn"] += n
            counts["rpn_norm"] += max(n, 1.0)
            counts["roi"] += float(valid.sum())
            counts["fg"] += float(is_fg.sum())
            counts["seg"] += float((batch["seg_gt"][i] != IGNORE).sum())
        counts = {k: max(v, 1.0) for k, v in counts.items()}
        counts["images"] = float(len(rois))
        return tgs, counts

    def step(self, batch, rois, roi_valid, noise, images=None) -> dict:
        """One step on ``batch`` (the program's batch dict, on the device)
        with the program's proposals. Returns the seven terms. ``images``
        (a fault for the limits' readings) keeps only the first so many
        images, the mean taken over them."""
        if images is not None:
            batch = {k: v[:images] for k, v in batch.items()}
            rois, roi_valid = rois[:images], roi_valid[:images]
            noise = {k: v[:images] for k, v in noise.items()}
        tgs, counts = self.targets(batch, rois, roi_valid, noise)
        totals = dict.fromkeys(LOSS_KEYS, 0.0)
        train = [k for k, v in self.params.items() if v.requires_grad]
        for k in train:
            self.params[k].grad = None
        for i in range(len(rois)):
            gt = {"boxes": batch["gt_boxes"][i], "classes": batch["gt_classes"][i],
                  "valid": batch["gt_valid"][i].bool(), "masks": batch["gt_masks"][i],
                  "seg_gt": batch["seg_gt"][i]}
            terms = self.image_losses(batch["images"][i].float(), batch["im_hw"][i], gt, tgs[i],
                                      counts, noise["unknown"][i])
            sum(terms.values()).backward()
            for k, v in terms.items():
                totals[k] += float(v.detach())
        self.update(train)
        return totals

    def update(self, names):
        tc = self.tc
        grads = [self.params[k].grad for k in names]
        norm = torch.norm(torch.stack([g.norm() for g in grads]))
        scale = min(1.0, tc["grad_clip"] / (float(norm) + 1e-6)) if tc["grad_clip"] > 0 else 1.0
        self.grad_norms = {k: float(g.norm()) * scale for k, g in zip(names, grads)}
        frac = min(self.count / max(tc["warmup_iteration"], 1), 1.0)
        lr = tc["lr"] * (tc["warmup_factor"] + (1 - tc["warmup_factor"]) * frac)
        for b in tc["decay_iteration"]:
            lr *= tc["decay_factor"] if self.count >= b else 1.0
        with torch.no_grad():
            for k in names:
                p = self.params[k]
                mult, wd = group_rule(k, tc)
                d = p.grad * scale + wd * p
                self.buf[k] = d.clone() if k not in self.buf else tc["momentum"] * self.buf[k] + d
                p -= lr * mult * self.buf[k]
        self.count += 1


def trainable(name: str, net: dict) -> bool:
    """Frozen: the stem and, with stage 2 frozen, res2 (Detectron's
    freeze_at); frozen-BN affines are constants."""
    if name.endswith((".scale", ".bias")) and (".bn" in name or "shortcut_bn" in name) \
            and net["norm"] == "frozen_bn":
        return False
    frozen = []
    if 1 in net["frozen_stages"]:
        frozen += ["backbone_net.conv1.", "backbone_net.bn1."]
    if 2 in net["frozen_stages"]:
        frozen.append("backbone_net.res2_")
    return not name.startswith(tuple(frozen))


def group_rule(name: str, tc: dict) -> tuple[float, float]:
    """(learning-rate multiple, weight decay) of a trainable tensor."""
    if "offset_conv" in name:
        return tc["dcn_offset_lr_mult"], (0.0 if name.endswith(".bias") else tc["wd"])
    if name.endswith((".bias", ".scale")):
        return 2.0, 0.0
    return 1.0, tc["wd"]


def leaf_gap(got: dict, want: dict, skip=(), median: bool = False) -> float:
    """The worst (or, with ``median``, the median) leaf of
    |norm(got) - norm(want)| over the larger of the leaf's reference norm and
    the median leaf's."""
    names = [k for k in want if k not in skip]
    ref = {k: float(want[k]) for k in names}
    med = sorted(ref.values())[len(ref) // 2] if ref else 0.0
    gaps = sorted(abs(float(got[k]) - ref[k]) / max(ref[k], med, 1e-30) for k in names)
    if not gaps:
        return 0.0
    return gaps[len(gaps) // 2] if median else gaps[-1]


