"""Plain float32 UPSNet inference, written from the paper and the Detectron
conventions, for judging the program's outputs.

UPSNet (arXiv:1901.03784): a caffe-layout ResNet (stride on each block's
first 1x1; deformable 3x3 in the stages a configuration names), an FPN with
P6 subsampled from P5, a shared RPN head, pyramid proposals with greedy NMS,
an FPN RoIAlign (Detectron, before ``aligned=True``) feeding a two-fc box
head and a four-conv mask head, a semantic FCN head of deformable convs on
P2..P5 upsampled to P2, and the panoptic head: stuff logits, per instance
the thing channel inside its box plus its pasted mask logits, and an unknown
channel. Boxes use the legacy +1 width.

Everything runs in plain ``torch`` in float32 with TF32 off, one image at a
time, from a state dict of float32 tensors (the benchmark makes the weights;
their names are the checkpoint layout). Nothing of the program is imported.
``fp8=True`` rounds every conv and dense input and weight, and the scores
and boxes of the proposals and of the detection candidates, through float8
e4m3 with one scale per tensor: the control that stands in for a program
that computes below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STRIDES = (4, 8, 16, 32, 64)
FP8_MAX = 448.0
BBOX_CLIP = math.log(1000.0 / 16.0)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Ref:
    """The network of one configuration (``cfg``: the nested ``model`` dict of
    a benchmark configuration file) over the state dict ``sd``."""

    def __init__(self, cfg: dict, sd: dict, fp8: bool = False):
        self.sd, self.fp8 = sd, fp8
        self.net, self.test, self.ds = cfg["network"], cfg["test"], cfg["dataset"]
        self.dcn_impl = self.net["dcn_impl"]  # training takes dcn_impl_train
        names = {k.split(".")[1] for k in sd if k.startswith("backbone_net.res")}
        self.blocks = [sorted((n for n in names if n.startswith(f"res{s}_")),
                              key=lambda n: int(n.split("_")[1])) for s in (2, 3, 4, 5)]

    # -- primitives ----------------------------------------------------------
    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def conv(self, x, name, stride=1, pad=None):
        w = self.sd[f"{name}.weight"]
        b = self.sd.get(f"{name}.bias")
        return F.conv2d(self.q(x), self.q(w), b, stride, w.shape[-1] // 2 if pad is None else pad)

    def bn(self, x, name):
        return x * self.sd[f"{name}.scale"][None, :, None, None] + self.sd[f"{name}.bias"][None, :, None, None]

    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.sd[f"{name}.weight"]), self.sd[f"{name}.bias"])

    def deform(self, x, name, impl: str):
        """DCNv1, stride 1, 3x3: each tap samples x bilinearly (zero outside
        the map) at its grid position plus the predicted (dy, dx)."""
        off = self.conv(x, f"{name}.offset_conv")  # (B, 18, H, W), (dy, dx) per tap
        b, c, h, w = x.shape
        dy, dx = off[:, 0::2], off[:, 1::2]
        if impl in ("pallas", "mxu", "shift"):
            dy = dy.clamp(-float(self.net["dcn_max_dy"]), float(self.net["dcn_max_dy"]))
        taps = torch.arange(9, device=x.device)
        ky = (taps // 3 - 1).float()[None, :, None, None]
        kx = (taps % 3 - 1).float()[None, :, None, None]
        ys = torch.arange(h, device=x.device, dtype=torch.float32)[None, None, :, None] + ky + dy
        xs = torch.arange(w, device=x.device, dtype=torch.float32)[None, None, None, :] + kx + dx
        wt = self.q(self.sd[f"{name}.weight"])  # (O, C, 3, 3)
        out = []
        for i in range(b):
            cols = bilinear_zero(self.q(x[i]), ys[i], xs[i])  # (C, 9, H, W), tap = 3 ky + kx
            out.append((wt.reshape(wt.shape[0], c * 9) @ cols.reshape(c * 9, h * w)).reshape(-1, h, w))
        y = torch.stack(out)
        bias = self.sd.get(f"{name}.bias")
        return y if bias is None else y + bias[None, :, None, None]

    # -- trunk ---------------------------------------------------------------
    def backbone(self, x):
        p = "backbone_net"
        x = torch.relu(self.bn(self.conv(x, f"{p}.conv1", 2), f"{p}.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for s, names in zip((2, 3, 4, 5), self.blocks):
            for j, n in enumerate(names):
                x = self.bottleneck(x, f"{p}.{n}", 2 if (j == 0 and s > 2) else 1)
            outs.append(x)
        return outs

    def bottleneck(self, x, p, stride):
        res = x
        if f"{p}.shortcut_conv.weight" in self.sd:
            res = self.bn(self.conv(x, f"{p}.shortcut_conv", stride), f"{p}.shortcut_bn")
        y = torch.relu(self.bn(self.conv(x, f"{p}.conv1", stride), f"{p}.bn1"))
        if f"{p}.conv2.offset_conv.weight" in self.sd:
            y = self.deform(y, f"{p}.conv2", self.dcn_impl)
        else:
            y = self.conv(y, f"{p}.conv2")
        y = torch.relu(self.bn(y, f"{p}.bn2"))
        y = self.bn(self.conv(y, f"{p}.conv3"), f"{p}.bn3")
        return torch.relu(y + res)

    def fpn(self, feats):
        lat = [self.conv(c, f"fpn.lateral{i}") for i, c in enumerate(feats, start=2)]
        tops = [lat[3]]
        for i in (2, 1, 0):
            up = F.interpolate(tops[0], scale_factor=2, mode="nearest")
            tops.insert(0, lat[i] + up[:, :, :lat[i].shape[2], :lat[i].shape[3]])
        ps = [self.conv(t, f"fpn.output{i}") for i, t in enumerate(tops, start=2)]
        return ps + [ps[3][:, :, ::2, ::2]]

    def rpn(self, pyramid):
        cls, bbox = [], []
        for p in pyramid:
            h = torch.relu(self.conv(p, "rpn.conv"))
            cls.append(self.conv(h, "rpn.cls_score").permute(0, 2, 3, 1))
            bbox.append(self.conv(h, "rpn.bbox_pred").permute(0, 2, 3, 1))
        return cls, bbox

    def fcn(self, pyramid):
        hw = pyramid[0].shape[2:]
        feats = []
        for lvl, p in enumerate(pyramid[:4], start=2):
            sub = "fcn_head.subnet" if self.net["fcn_shared_subnet"] else f"fcn_head.subnet{lvl}"
            x = p
            for j in range(self.net["fcn_num_layers"]):
                if self.net["fcn_with_dcn"]:
                    x = torch.relu(self.deform(x, f"{sub}.dcn{j + 1}", self.dcn_impl))
                else:
                    x = torch.relu(self.conv(x, f"{sub}.conv{j + 1}"))
            if tuple(x.shape[2:]) != tuple(hw):
                x = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)
            feats.append(x)
        return self.conv(torch.cat(feats, 1), "fcn_head.score")

    def trunk(self, image):
        """image (H, W, 3) mean-subtracted BGR -> pyramid P2..P6, RPN logits
        and deltas per level (channel-last), semantic logits (C, H/4, W/4)."""
        x = image.float().permute(2, 0, 1)[None]
        pyramid = self.fpn(self.backbone(x))
        cls, bbox = self.rpn(pyramid)
        return pyramid, cls, bbox, self.fcn(pyramid)[0]

    # -- heads ---------------------------------------------------------------
    def box_head(self, pooled):  # (R, C, P, P)
        x = pooled.permute(0, 2, 3, 1).reshape(pooled.shape[0], -1)
        x = torch.relu(self.linear(x, "box_head.fc1"))
        x = torch.relu(self.linear(x, "box_head.fc2"))
        return self.linear(x, "box_head.cls_score"), self.linear(x, "box_head.bbox_pred")

    def mask_head(self, pooled):  # (R, C, 14, 14) -> (R, classes, 28, 28)
        x = pooled
        for i in range(4):
            x = torch.relu(self.conv(x, f"mask_head.conv{i + 1}"))
        w, b = self.sd["mask_head.deconv.weight"], self.sd["mask_head.deconv.bias"]
        x = torch.relu(F.conv_transpose2d(self.q(x), self.q(w), b, stride=2))
        return self.conv(x, "mask_head.mask_score")

    def roi_align(self, pyramid, rois, pooled: int):
        return roi_align(pyramid[:4], rois, pooled, self.net["roi_sampling_ratio"])

    def boxes_per_class(self, rois, cls_score, bbox_pred, im_hw):
        scores = torch.softmax(cls_score.float(), -1)
        deltas = bbox_pred.float().reshape(rois.shape[0], -1, 4)
        boxes = clip(decode(rois[:, None, :], deltas, self.net["bbox_reg_weights"]), im_hw)
        return self.q(boxes), self.q(scores)

    # -- the whole predict path ----------------------------------------------
    def proposals(self, cls, bbox, im_hw):
        t = self.test
        return pyramid_proposals([c.float() for c in cls], [b.float() for b in bbox],
                                 self.anchors(cls), im_hw, t["rpn_pre_nms_top_n"],
                                 t["rpn_post_nms_top_n"], t["rpn_nms_thresh"], q=self.q)

    def anchors(self, cls):
        return [level_anchors(c.shape[1], c.shape[2], s, self.net["anchor_ratios"],
                              self.net["anchor_scale"]).to(c.device)
                for c, s in zip(cls, STRIDES)]

    def detect(self, boxes, scores, valid):
        t = self.test
        scores = torch.where(valid[:, None], scores, torch.zeros_like(scores))
        return detection_nms(boxes, scores, t["score_thresh"], t["nms_thresh"], t["max_det"],
                             t.get("detection_nms_pool", 2048))

    def masks_for(self, pyramid, boxes, classes):
        logits = self.mask_head(self.roi_align(pyramid, boxes, self.net["pooled_size_mask"]))
        return logits[torch.arange(len(classes), device=logits.device), classes.long()]

    def predict(self, image, im_hw) -> dict:
        """The program's outputs for one image, in the program's place (the
        control), with the intermediates the comparison reads."""
        pyramid, cls, bbox, seg = self.trunk(image)
        rois, roi_scores, roi_valid = self.proposals(cls, bbox, im_hw)
        box_cls, box_bbox = self.box_head(self.roi_align(pyramid, rois, self.net["pooled_size_box"]))
        boxes_pc, scores_pc = self.boxes_per_class(rois, box_cls, box_bbox, im_hw)
        boxes, scores, classes, det_valid = self.detect(boxes_pc, scores_pc, roi_valid)
        mask_logits = self.masks_for(pyramid, boxes, classes)
        seg_hwc = seg.permute(1, 2, 0)
        pan_map, pan_keep = panoptic_fuse(seg_hwc, boxes, classes, mask_logits, scores, det_valid,
                                          self.test["panoptic_score_thresh"],
                                          self.test["panoptic_mask_overlap_thresh"],
                                          self.ds["num_stuff"])
        return {"fpn": pyramid, "rpn_cls": cls, "rpn_bbox": bbox, "seg_logits": seg_hwc,
                "rois": rois, "roi_scores": roi_scores, "roi_valid": roi_valid,
                "box_cls": box_cls, "box_bbox": box_bbox, "boxes": boxes, "scores": scores,
                "classes": classes, "det_valid": det_valid, "mask_logits": mask_logits,
                "seg_pred_q": seg_hwc.argmax(-1), "pan_map": pan_map, "pan_keep": pan_keep}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def bilinear_zero(x, ys, xs):
    """x (C, H, W); ys, xs (...) float coordinates -> (C, ...): bilinear
    samples, corners outside the map contribute zero, nothing beyond one
    pixel outside."""
    c, h, w = x.shape
    flat = x.reshape(c, h * w)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    inside = (ys > -1) & (ys < h) & (xs > -1) & (xs < w)
    out = torch.zeros((c, *ys.shape), dtype=x.dtype, device=x.device)
    for yy, xx, wgt in ((y0, x0, (1 - ly) * (1 - lx)), (y0, x0 + 1, (1 - ly) * lx),
                        (y0 + 1, x0, ly * (1 - lx)), (y0 + 1, x0 + 1, ly * lx)):
        ok = inside & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        out += flat[:, idx.reshape(-1)].reshape(out.shape) * (wgt * ok)[None]
    return out


def roi_align(levels, rois, pooled: int, ratio: int):
    """Detectron RoIAlign over P2..P5 (each (1, C, H, W)): each RoI (x1, y1,
    x2, y2) goes to level floor(4 + log2(sqrt(wh) / 224)) in [2, 5]; each of
    its P x P bins averages ratio^2 samples at sub-bin centres, with no
    half-pixel shift, the extent at least one cell, samples beyond [-1, size]
    zero, coordinates clamped below at 0 and held at the last row/column."""
    n = rois.shape[0]
    c = levels[0].shape[1]
    out = torch.zeros((n, c, pooled, pooled), device=rois.device)
    w = rois[:, 2] - rois[:, 0] + 1
    h = rois[:, 3] - rois[:, 1] + 1
    lvl = torch.floor(4 + torch.log2(torch.sqrt((w * h).clamp(min=1e-6)) / 224 + 1e-12)).clamp(2, 5)
    frac = (torch.arange(pooled, device=rois.device, dtype=torch.float32)[:, None]
            + (torch.arange(ratio, device=rois.device, dtype=torch.float32)[None, :] + 0.5) / ratio)
    for k in range(2, 6):
        sel = torch.nonzero(lvl == k).flatten()
        if sel.numel() == 0:
            continue
        feat = levels[k - 2][0]
        fh, fw = feat.shape[1:]
        r = rois[sel] / STRIDES[k - 2]
        rw = (r[:, 2] - r[:, 0]).clamp(min=1.0)
        rh = (r[:, 3] - r[:, 1]).clamp(min=1.0)
        ys = r[:, 1, None, None] + frac[None] * (rh / pooled)[:, None, None]  # (n, P, S)
        xs = r[:, 0, None, None] + frac[None] * (rw / pooled)[:, None, None]
        m = sel.numel()
        yy = ys[:, :, None, :, None].expand(m, pooled, pooled, ratio, ratio)
        xx = xs[:, None, :, None, :].expand(m, pooled, pooled, ratio, ratio)
        vals = _roi_sample(feat, yy, xx)  # (C, m, P, P, S, S)
        out[sel] = vals.mean(dim=(-2, -1)).permute(1, 0, 2, 3)
    return out


def _roi_sample(feat, y, x):
    c, h, w = feat.shape
    inside = (y >= -1.0) & (y <= h) & (x >= -1.0) & (x <= w)
    y, x = y.clamp(min=0.0), x.clamp(min=0.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    ys_, xs_ = y0 >= h - 1, x0 >= w - 1
    y0 = torch.where(ys_, torch.full_like(y0, h - 1), y0)
    x0 = torch.where(xs_, torch.full_like(x0, w - 1), x0)
    y = torch.where(ys_, y0, y)
    x = torch.where(xs_, x0, x)
    y1 = torch.where(ys_, y0, y0 + 1)
    x1 = torch.where(xs_, x0, x0 + 1)
    ly, lx = y - y0, x - x0
    flat = feat.reshape(c, h * w)
    out = 0
    for yy, xx, wgt in ((y0, x0, (1 - ly) * (1 - lx)), (y0, x1, (1 - ly) * lx),
                        (y1, x0, ly * (1 - lx)), (y1, x1, ly * lx)):
        idx = (yy * w + xx).long()
        out = out + flat[:, idx.reshape(-1)].reshape(c, *idx.shape) * (wgt * inside)[None]
    return out


# ---------------------------------------------------------------------------
# boxes, anchors, NMS
# ---------------------------------------------------------------------------


def level_anchors(fh: int, fw: int, stride: int, ratios, scale: float) -> torch.Tensor:
    """Detectron anchors of one level, (fh * fw * A, 4) in (y, x, a) order:
    a stride x stride base box, each aspect ratio at equal area with the
    legacy rounding, scaled by ``scale``, shifted over the grid."""
    size = float(stride * stride)
    ctr = 0.5 * (stride - 1)
    cell = []
    for r in ratios:
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        ws, hs = ws * scale, hs * scale
        cell.append([ctr - 0.5 * (ws - 1), ctr - 0.5 * (hs - 1), ctr + 0.5 * (ws - 1),
                     ctr + 0.5 * (hs - 1)])
    cell = torch.tensor(cell, dtype=torch.float32)
    sy, sx = torch.meshgrid(torch.arange(fh, dtype=torch.float32) * stride,
                            torch.arange(fw, dtype=torch.float32) * stride, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


def decode(boxes, deltas, weights=(1.0, 1.0, 1.0, 1.0)):
    w = boxes[..., 2] - boxes[..., 0] + 1
    h = boxes[..., 3] - boxes[..., 1] + 1
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = (deltas[..., 2] / weights[2]).clamp(max=BBOX_CLIP)
    dh = (deltas[..., 3] / weights[3]).clamp(max=BBOX_CLIP)
    px, py = dx * w + cx, dy * h + cy
    pw, ph = torch.exp(dw) * w, torch.exp(dh) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw - 1, py + 0.5 * ph - 1], -1)


def clip(boxes, im_hw):
    hmax, wmax = float(im_hw[0]) - 1, float(im_hw[1]) - 1
    return torch.stack([boxes[..., 0].clamp(0, wmax), boxes[..., 1].clamp(0, hmax),
                        boxes[..., 2].clamp(0, wmax), boxes[..., 3].clamp(0, hmax)], -1)


def iou(a, b):
    """(N, 4) x (M, 4) -> (N, M), legacy +1 areas."""
    area_a = ((a[:, 2] - a[:, 0] + 1).clamp(min=0) * (a[:, 3] - a[:, 1] + 1).clamp(min=0))
    area_b = ((b[:, 2] - b[:, 0] + 1).clamp(min=0) * (b[:, 3] - b[:, 1] + 1).clamp(min=0))
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros_like(inter))


def greedy_nms(boxes, scores, thresh: float) -> torch.Tensor:
    """Indices kept by greedy NMS, in descending score order (ties to the
    lower index); entries scored -inf never enter."""
    order = torch.sort(-scores, stable=True).indices
    order = order[torch.isfinite(scores[order])]
    sup = (iou(boxes[order], boxes[order]) > thresh).cpu().numpy()
    keep = np.ones(len(order), bool)
    for i in range(len(order)):
        if keep[i]:
            keep[i + 1:] &= ~sup[i, i + 1:]
    return order[torch.from_numpy(np.nonzero(keep)[0]).to(order.device)]


def top_k(x, k: int):
    order = torch.sort(-x, stable=True).indices[:k]
    return x[order], order


def pyramid_proposals(cls, bbox, anchors, im_hw, pre_n: int, post_n: int, thresh: float,
                      cap: int = 4096, q=lambda x: x):
    """Per level: fg softmax, anchors decoded and clipped, empty boxes out,
    top ``pre_n``; all levels joined, capped at ``cap``, greedy NMS, the
    first ``post_n`` kept. Returns rois (post_n, 4) zero-padded, scores
    (-inf padded), valid."""
    all_b, all_s = [], []
    for c, d, a in zip(cls, bbox, anchors):
        logits = c[0].reshape(-1, 2)
        s = q(torch.softmax(logits, -1)[:, 1])
        b = q(clip(decode(a, d[0].reshape(-1, 4)), im_hw))
        ok = (b[:, 2] - b[:, 0] + 1 > 0) & (b[:, 3] - b[:, 1] + 1 > 0)
        s = torch.where(ok, s, torch.full_like(s, -math.inf))
        s, i = top_k(s, min(pre_n, len(s)))
        all_b.append(b[i])
        all_s.append(s)
    boxes, scores = torch.cat(all_b), torch.cat(all_s)
    if len(scores) > cap:
        scores, i = top_k(scores, cap)
        boxes = boxes[i]
    keep = greedy_nms(boxes, scores, thresh)[:post_n]
    n = len(keep)
    rois = torch.zeros((post_n, 4), device=boxes.device)
    out_s = torch.full((post_n,), -math.inf, device=boxes.device)
    rois[:n], out_s[:n] = boxes[keep], scores[keep]
    valid = torch.arange(post_n, device=boxes.device) < n
    return rois, out_s, valid


def detection_nms(boxes, scores, score_thresh, nms_thresh, max_det, pool):
    """boxes (R, C, 4), scores (R, C): classes 1.. over every RoI, those
    under ``score_thresh`` out, the ``pool`` best (RoI-major order breaks
    ties), greedy NMS within each class, the ``max_det`` best kept. Padded
    slots repeat the best candidate with score -inf and valid False."""
    r, c = scores.shape
    sc = scores[:, 1:].reshape(-1)
    bx = boxes[:, 1:].reshape(-1, 4)
    cl = torch.arange(1, c, device=scores.device).repeat(r)
    sc = torch.where(sc >= score_thresh, sc, torch.full_like(sc, -math.inf))
    top_s, top_i = top_k(sc, min(pool, len(sc)))
    kept = []
    for k in torch.unique(cl[top_i[torch.isfinite(top_s)]]).tolist():
        members = torch.nonzero(cl[top_i] == k).flatten()
        s = top_s[members]
        kept.append(members[greedy_nms(bx[top_i[members]], s, nms_thresh)])
    kept = torch.cat(kept) if kept else torch.zeros(0, dtype=torch.long, device=sc.device)
    # the pool is in descending score order, so pool order is score order
    # with ties to the better-ranked candidate
    kept = torch.sort(kept).values[:max_det]
    n = len(kept)
    slot = torch.zeros(max_det, dtype=torch.long, device=sc.device)
    slot[:n] = kept
    idx = top_i[slot]
    valid = torch.arange(max_det, device=sc.device) < n
    return (bx[idx], torch.where(valid, sc[idx], torch.full_like(sc[idx], -math.inf)),
            cl[idx], valid)


# ---------------------------------------------------------------------------
# panoptic fusion
# ---------------------------------------------------------------------------


def paste(masks, boxes, hw):
    """(N, M, M) values pasted bilinearly into (N, H, W) canvases: pixel p
    of a box [lo, hi] (span hi - lo + 1) reads mask coordinate
    (p - lo + 0.5) / span * M - 0.5, clamped to [0, M - 1]; zero outside
    the box's pixel window [floor(lo), ceil(hi)]."""
    m = masks.shape[-1]

    def hat(lo, hi, size):
        span = (hi - lo + 1).clamp(min=1.0)
        p = torch.arange(size, dtype=torch.float32, device=masks.device)[None]
        cc = ((p - lo[:, None] + 0.5) / span[:, None] * m - 0.5).clamp(0, m - 1)
        wgt = (1 - (cc[..., None] - torch.arange(m, device=masks.device)).abs()).clamp(min=0)
        inside = (p >= torch.floor(lo)[:, None]) & (p <= torch.ceil(hi)[:, None])
        return wgt * inside[..., None]

    ry = hat(boxes[:, 1], boxes[:, 3], hw[0])
    rx = hat(boxes[:, 0], boxes[:, 2], hw[1])
    return ry @ masks @ rx.transpose(1, 2)


def box_window(boxes, hw):
    ys = torch.arange(hw[0], device=boxes.device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(hw[1], device=boxes.device, dtype=torch.float32)[None, None, :]
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    return ((ys >= torch.floor(y1)) & (ys <= torch.ceil(y2))
            & (xs >= torch.floor(x1)) & (xs <= torch.ceil(x2))).float()


def mask_removal(pasted_prob, candidate, thresh: float):
    """Walk the detections in order; keep one when at least ``thresh`` of its
    (prob >= 0.5) pixels are not yet claimed; kept ones claim theirs."""
    binm = pasted_prob >= 0.5
    claimed = torch.zeros_like(binm[0])
    keep = torch.zeros(len(candidate), dtype=torch.bool, device=binm.device)
    fresh_share = torch.zeros(len(candidate), device=binm.device)
    for i in range(len(candidate)):
        area = binm[i].sum().float()
        fresh = (binm[i] & ~claimed).sum().float()
        fresh_share[i] = fresh / area.clamp(min=1)
        keep[i] = bool(candidate[i]) and area > 0 and fresh_share[i] >= thresh
        if keep[i]:
            claimed |= binm[i]
    return keep, fresh_share


def panoptic_stack(seg_hwc, boxes, classes, mask_logits, keep, num_stuff: int):
    """(S + N + 1, H, W) panoptic logits at 1/4 scale: stuff channels; per
    kept instance its thing channel inside its box plus its pasted mask
    logits (-1e4 when not kept); unknown = max thing logit - max instance
    seg term (0 without instances)."""
    hw = seg_hwc.shape[:2]
    bq = boxes * 0.25
    stuff = seg_hwc[..., :num_stuff].permute(2, 0, 1)
    things = seg_hwc[..., num_stuff:].permute(2, 0, 1)
    seg_t = things[(classes - 1).clamp(min=0).long()] * box_window(bq, hw)
    inst = seg_t + paste(mask_logits, bq, hw)
    neg = torch.full_like(inst, -1e4)
    inst = torch.where(keep[:, None, None], inst, neg)
    segt_max = torch.where(keep[:, None, None], seg_t, neg).amax(0)
    if not bool(keep.any()):
        segt_max = torch.zeros_like(segt_max)
    unknown = things.amax(0) - segt_max
    return torch.cat([stuff, inst, unknown[None]])


def panoptic_fuse(seg_hwc, boxes, classes, mask_logits, scores, valid, score_thresh,
                  overlap_thresh, num_stuff):
    hw = seg_hwc.shape[:2]
    prob = paste(torch.sigmoid(mask_logits), boxes * 0.25, hw)
    keep, _ = mask_removal(prob, valid & (scores >= score_thresh), overlap_thresh)
    stack = panoptic_stack(seg_hwc, boxes, classes, mask_logits, keep, num_stuff)
    return stack.argmax(0), keep
