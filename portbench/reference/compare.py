"""The comparison that decides ``correct`` for the inference cells.

Each sampled image's program outputs (``predict_step``'s returns and the
intermediates captured on the timed path) are judged against the float32
reference (``upsnet_ref.Ref``) on the same image and weights. Continuous
stages are compared as relative L2 errors. Discrete stages are judged by
what they say: where the program chose (proposals, detections, the argmax
maps, the mask removal), the reference is run on the program's choice and
reports how far that choice lies from its own best, so a near-tie that
bfloat16 rounds the other way reads small and a wrong answer reads large.
The discrete stages are judged on the program's own inputs to them, since
bfloat16 rounding reorders near-equal candidates among hundreds of
thousands: the proposals are worked out again from the program's RPN
outputs, the detections from its box head's outputs at its proposals, the
heads at its proposals and detections; each of those inputs is compared on
its own (``rpn_err``, ``box_err``), and the maps and the mask removal are
judged by the reference's own logits and masks, the panoptic map with the
program's own mask-removal decisions. Those decisions are read one by one
(``keep_margin``: how far the reference lies from deciding as the program
did) but held to no limit: the float8 control reads as low as sound runs on
some seeds, so the number has no upper reading.

Every number is lower-is-better; a run is correct when each number that the
cell's mix file gives a limit (``limits``) is at or under it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.upsnet_ref import Ref, panoptic_stack, paste

NUMBERS = ("fpn_err", "rpn_err", "seg_err", "prop_err", "prop_miss", "box_err", "det_err",
           "mask_err", "seg_gap", "pan_gap", "keep_margin")
PROP_DIST = 0.05  # a match: every coordinate within this share of the box's longer side


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / den if den > 0 else float((a - b).norm())


def _sorted_gap(a, b) -> float:
    """Largest gap between two descending score lists, rank by rank, the
    shorter one padded with zeros."""
    n = max(len(a), len(b), 1)
    pa = torch.zeros(n, dtype=torch.float64)
    pb = torch.zeros(n, dtype=torch.float64)
    pa[:len(a)] = torch.sort(a.double().cpu(), descending=True).values
    pb[:len(b)] = torch.sort(b.double().cpu(), descending=True).values
    return float((pa - pb).abs().max())


def box_dist(a, b):
    """For each box of ``a``, the nearest box of ``b`` by the largest
    coordinate gap over the longer side of the ``a`` box (at least 1 px).
    Not IoU: clipping leaves sub-pixel boxes along the image's edges, whose
    IoU with a copy a rounding away is anything from 0 to 1."""
    side = torch.maximum(a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]).clamp(min=1.0)
    gap = (a[:, None, :] - b[None, :, :]).abs().amax(-1)
    return gap.amin(1) / side


def _flip_margin(prob, cmax, keep_ref: bool, thresh: float) -> float:
    """How far the reference's decision on one instance lies from the
    program's: the least change of a probability, |p - 0.5|, such that
    flipping every pixel within it that moves the unclaimed share toward
    the threshold turns the decision over (0.5 where none does). ``prob``
    is the instance's pasted mask, ``cmax`` the pixelwise largest mask of
    the instances kept before it (a pixel is claimed where that is >= 0.5).
    A pixel moves by its own mask turning on or off, or by its claim
    turning over (at |cmax - 0.5|), whichever is nearer."""
    on, free = prob >= 0.5, cmax < 0.5
    f, a = float((on & free).sum()), float(on.sum())
    own, claim = (prob - 0.5).abs(), (cmax - 0.5).abs()
    if keep_ref:  # toward dropping
        by_claim = claim < own
        moves = [(on & free, torch.minimum(own, claim), torch.where(by_claim, 0.0, -1.0), -1.0),
                 (~on & ~free, own, 1.0, 0.0)]
    else:  # toward keeping
        by_claim = claim < own
        moves = [(~on & free, own, 1.0, 1.0),
                 (on & ~free, torch.minimum(own, claim), torch.where(by_claim, 0.0, -1.0),
                  torch.where(by_claim, 1.0, 0.0))]
    ms, das, dfs = [], [], []
    for where, margin, da, df in moves:
        ms.append(margin[where])
        das.append(torch.as_tensor(da, device=where.device).expand(where.shape)[where].double())
        dfs.append(torch.as_tensor(df, device=where.device).expand(where.shape)[where].double())
    m, order = torch.sort(torch.cat(ms))
    f2 = f + torch.cumsum(torch.cat(dfs)[order], 0)
    a2 = a + torch.cumsum(torch.cat(das)[order], 0)
    turned = (a2 > 0) & (f2 / a2.clamp(min=1.0) >= thresh)
    if keep_ref:
        turned = ~turned
    idx = torch.nonzero(turned)
    return float(m[idx[0, 0]]) if len(idx) else 0.5


def keep_margin(prob, candidate, keep, thresh: float) -> float:
    """The program's mask-removal decisions judged one by one by the
    reference's pasted masks (``prob``, (N, H, W), of the program's
    detections), each with the pixels claimed by the instances that the
    program kept before it, so that one decision's error does not cascade:
    the widest ``_flip_margin`` of a decision the reference takes otherwise,
    0 where it agrees on each. A kept instance that was no candidate reads
    inf."""
    cmax = torch.zeros_like(prob[0])
    worst = 0.0
    for i in range(len(keep)):
        k = bool(keep[i])
        if k and not bool(candidate[i]):
            return math.inf
        if bool(candidate[i]):
            on = prob[i] >= 0.5
            a = float(on.sum())
            share = float((on & (cmax < 0.5)).sum()) / max(a, 1.0)
            keep_ref = a > 0 and share >= thresh
            if keep_ref != k:
                worst = max(worst, _flip_margin(prob[i], cmax, keep_ref, thresh))
        if k:
            cmax = torch.maximum(cmax, prob[i])
    return worst


def judge_image(ref: Ref, prog: dict, image, im_hw) -> dict:
    """The numbers of one image. ``prog`` holds tensors of that image only:
    fpn (5 maps (1, C, h, w)), rpn_cls / rpn_bbox (per level (1, h, w, k)),
    seg_logits (H/4, W/4, C), rois / roi_scores / roi_valid, box_cls /
    box_bbox (one row per RoI), boxes / scores / classes / det_valid /
    mask_logits (one row per detection slot), seg_pred_q, pan_map,
    pan_keep."""
    dev = image.device
    p = {k: ([t.to(dev).float() for t in v] if isinstance(v, (list, tuple)) else v.to(dev))
         for k, v in prog.items()}
    out = {}
    with torch.no_grad():
        pyramid, cls, bbox, seg = ref.trunk(image)
        seg = seg.permute(1, 2, 0)
        out["fpn_err"] = max(rel(a, b) for a, b in zip(p["fpn"], pyramid))
        out["rpn_err"] = max(rel(a, b) for a, b in zip(p["rpn_cls"] + p["rpn_bbox"], cls + bbox))
        out["seg_err"] = rel(p["seg_logits"].float(), seg)

        # proposals, worked out again from the program's RPN outputs
        r_rois, r_scores, r_valid = ref.proposals(p["rpn_cls"], p["rpn_bbox"], im_hw)
        pv = p["roi_valid"].bool()
        out["prop_err"] = _sorted_gap(p["roi_scores"][pv].float(), r_scores[r_valid])
        mine = r_rois[r_valid]
        if len(mine) and int(pv.sum()):
            out["prop_miss"] = float((box_dist(mine, p["rois"][pv].float()) > PROP_DIST).float().mean())
        else:
            out["prop_miss"] = 0.0 if len(mine) == int(pv.sum()) else 1.0

        # the box head at the program's proposals
        rois = p["rois"].float()
        box_cls, box_bbox = ref.box_head(ref.roi_align(pyramid, rois[pv], ref.net["pooled_size_box"]))
        out["box_err"] = max(rel(p["box_cls"][pv].float(), box_cls),
                             rel(p["box_bbox"][pv].float(), box_bbox))

        # detections: each of the program's, judged at the candidates that
        # the reference decodes from the program's box head outputs; and the
        # score list against the reference's NMS over them
        boxes_pc, scores_pc = ref.boxes_per_class(rois[pv], p["box_cls"][pv], p["box_bbox"][pv],
                                                  im_hw)
        dv = p["det_valid"].bool()
        d_boxes, d_scores, d_classes = p["boxes"].float(), p["scores"].float(), p["classes"].long()
        gaps = [0.0]
        for k in torch.nonzero(dv).flatten().tolist():
            c = int(d_classes[k])
            if not 1 <= c < scores_pc.shape[1]:
                gaps.append(math.inf)
                continue
            b = d_boxes[k]
            side = torch.maximum(b[2] - b[0], b[3] - b[1]).clamp(min=1.0)
            geo = (boxes_pc[:, c] - b).abs().amax(-1) / side
            gaps.append(float(((scores_pc[:, c] - d_scores[k]).abs() + geo).min()))
        _, r_det_scores, _, r_det_valid = ref.detect(boxes_pc, scores_pc,
                                                     torch.ones(len(boxes_pc), dtype=torch.bool,
                                                                device=dev))
        out["det_err"] = max(max(gaps), _sorted_gap(d_scores[dv], r_det_scores[r_det_valid]))

        # masks at the program's detections
        r_masks = ref.masks_for(pyramid, d_boxes, d_classes.clamp(0, scores_pc.shape[1] - 1))
        out["mask_err"] = rel(p["mask_logits"][dv].float(), r_masks[dv]) if int(dv.sum()) else 0.0

        # the argmax maps, judged by the reference's logits
        scale = float(seg.std())
        q = p["seg_pred_q"].long()
        if int(q.max()) >= seg.shape[-1] or q.shape != seg.shape[:2]:
            out["seg_gap"] = math.inf
        else:
            out["seg_gap"] = float((seg.amax(-1) - seg.gather(-1, q[..., None])[..., 0]).max()) / scale
        keep = p["pan_keep"].bool()
        if keep.shape != dv.shape:
            out["keep_margin"] = math.inf
        else:
            prob = paste(torch.sigmoid(r_masks), d_boxes * 0.25, seg.shape[:2])
            candidate = dv & (d_scores >= ref.test["panoptic_score_thresh"])
            out["keep_margin"] = keep_margin(prob, candidate, keep,
                                             ref.test["panoptic_mask_overlap_thresh"])
        stack = panoptic_stack(seg, d_boxes, d_classes, r_masks, keep, ref.ds["num_stuff"])
        pan = p["pan_map"].long()
        if int(pan.max()) >= stack.shape[0] or int(pan.min()) < 0 or pan.shape != seg.shape[:2]:
            out["pan_gap"] = math.inf
        else:
            out["pan_gap"] = float((stack.amax(0) - stack.gather(0, pan[None])[0]).max()) / scale
    return out


def judge(ref: Ref, progs: list, images: list, im_hws: list) -> dict:
    """The worst of each number over the images."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for prog, image, hw in zip(progs, images, im_hws):
        for k, v in judge_image(ref, prog, image, hw).items():
            worst[k] = max(worst[k], v) if not math.isnan(v) else math.inf
    return worst



# ---------------------------------------------------------------------------
# training cells
# ---------------------------------------------------------------------------

TRAIN_NUMBERS = ("loss1_err", "loss_err", "grad_err", "update_err", "update_med", "prop_err",
                 "prop_miss")


def train_run(model_cfg: dict, state: dict, records: list, dev, fp8: bool = False,
              images=None) -> dict:
    """The reference's three steps over the program's recorded steps (their
    batches, noise and proposals): the seven terms of each step, each
    trainable tensor's first momentum buffer (clipped gradient plus weight
    decay) and its clipped gradient, and its change over the steps, as norms."""
    from portbench.reference.train_ref import TrainRef

    ref = TrainRef(model_cfg, state, fp8=fp8)
    out = {"losses": []}
    for k, rec in enumerate(records):
        batch = {n: v.to(dev) for n, v in rec["batch"].items()}
        rois, _, valid = rec["proposals"]
        out["losses"].append(ref.step(batch, rois.float(), valid.bool(), rec["noise"], images))
        if k == 0:
            out["g1"] = {n: float(b.norm()) for n, b in ref.buf.items()}
            out["grad"] = dict(ref.grad_norms)
    out["dp"] = {n: float((ref.params[n].detach() - state[n]).norm()) for n in out["g1"]}
    return out


def train_numbers(side: dict, ref: dict) -> dict:
    """A side's (the program's, or a control's) readings against the
    reference's: the worst step and term of the losses, relative to the term
    (or a thousandth of the step's total, where the term is smaller); the
    worst leaf of the first gradient's and of the change's norms. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    (nought to rounding, as a bias under a softmax) are left out.
    ``loss1_err`` is the first step's alone, ``update_med`` the median
    leaf's gap of the change: the steady readings beside the worst ones,
    since random weights amplify rounding from step to step."""
    from portbench.reference.train_ref import leaf_gap

    per_step = []
    for got, want in zip(side["losses"], ref["losses"]):
        total = sum(abs(v) for v in want.values())
        per_step.append(max(abs(got[k] - v) / max(abs(v), 1e-3 * total, 1e-30)
                            for k, v in want.items()))
    grads = sorted(ref["grad"].values())
    med = grads[len(grads) // 2]
    skip = {n for n, v in ref["grad"].items() if v < 1e-3 * med}
    return {"loss1_err": per_step[0], "loss_err": max(per_step),
            "grad_err": leaf_gap(side["g1"], ref["g1"], skip),
            "update_err": leaf_gap(side["dp"], ref["dp"], skip),
            "update_med": leaf_gap(side["dp"], ref["dp"], skip, median=True)}


def train_proposal_numbers(model_cfg: dict, records: list, dev) -> dict:
    """The program's proposals of the recorded steps, worked out again from
    its RPN outputs with the training settings."""
    from portbench.reference.upsnet_ref import STRIDES, level_anchors, pyramid_proposals

    tc, net = model_cfg["train"], model_cfg["network"]
    worst = {"prop_err": 0.0, "prop_miss": 0.0}
    for rec in records:
        cls, bbox = rec["rpn"]
        rois, scores, valid = rec["proposals"]
        anchors = [level_anchors(c.shape[1], c.shape[2], s, net["anchor_ratios"],
                                 net["anchor_scale"]).to(dev) for c, s in zip(cls, STRIDES)]
        for j in range(len(rois)):
            im_hw = tuple(float(v) for v in rec["batch"]["im_hw"][j])
            r, s, v = pyramid_proposals([c[j:j + 1].float() for c in cls],
                                        [b[j:j + 1].float() for b in bbox], anchors, im_hw,
                                        tc["rpn_pre_nms_top_n"], tc["rpn_post_nms_top_n"],
                                        tc["rpn_nms_thresh"])
            pv = valid[j].bool()
            worst["prop_err"] = max(worst["prop_err"],
                                    _sorted_gap(scores[j][pv].float(), s[v]))
            mine = r[v]
            miss = (float((box_dist(mine, rois[j][pv].float()) > PROP_DIST).float().mean())
                    if len(mine) and int(pv.sum()) else float(len(mine) != int(pv.sum())))
            worst["prop_miss"] = max(worst["prop_miss"], miss)
    return worst


def judge_train(model_cfg: dict, state: dict, records: list, g1: dict, dp: dict, dev) -> dict:
    """The program's first three steps against the reference's."""
    if model_cfg["train"]["rpn_min_size"]:
        raise ValueError("the reference's proposals take no min_size")
    for rec in records:  # the reference steps every image of the batch
        if len(rec["proposals"][0]) != len(rec["batch"]["images"]):
            return dict.fromkeys(TRAIN_NUMBERS, math.inf)
    with torch.no_grad():
        numbers = train_proposal_numbers(model_cfg, records, dev)
    ref = train_run(model_cfg, state, records, dev)
    side = {"losses": [r["losses"] for r in records], "g1": g1, "dp": dp}
    numbers.update(train_numbers(side, ref))
    return numbers
