"""COCO -> Cityscapes fine-tuning weight surgery on a torch ``state_dict``.

The port of ``upsnet_tpu/convert/finetune.py``. The Cityscapes-w-COCO
configs start from a COCO-trained model. Every tensor whose shape does not
depend on the class count is copied; in the class-dependent final layers
(box ``cls_score`` / ``bbox_pred``, ``mask_score``, the FCN head's ``score``)
the Cityscapes initialisation stays, except for the rows of the classes
that have a COCO counterpart (the 8 Cityscapes things all exist in COCO),
which are copied.

The class axis is the output axis. A torch ``Linear`` weight is (out, in)
and a conv weight (out, in, kh, kw), so the classes are axis 0 here, where
flax's (in, out) kernels hold them on the trailing axis. ``bbox_pred`` has 4
rows a class.
"""

from __future__ import annotations

import torch

# cityscapes det label (1..8) -> coco det label (1..80)
CITYSCAPES_TO_COCO_LABEL = {
    1: 1,  # person
    2: 1,  # rider  <- person (no COCO rider)
    3: 3,  # car
    4: 8,  # truck
    5: 6,  # bus
    6: 7,  # train
    7: 4,  # motorcycle
    8: 2,  # bicycle
}

# the layers whose output axis is the class axis, and rows a class
CLASS_LAYERS = {"box_head.cls_score": 1, "box_head.bbox_pred": 4,
                "mask_head.mask_score": 1}
SEG_SCORE = "fcn_head.score"


def is_class_dependent(key: str) -> bool:
    """Whether the state_dict entry ``key`` is shaped by the class counts."""
    return key.rsplit(".", 1)[0] in (*CLASS_LAYERS, SEG_SCORE)


def _remap_rows(src: torch.Tensor, dst: torch.Tensor, mapping: dict,
                block: int) -> torch.Tensor:
    """dst with rows [d*block, (d+1)*block) = src's rows of class s for each
    d -> s of ``mapping``; the background block 0 is always copied."""
    out = dst.clone()
    out[:block] = src[:block]
    for d, s in mapping.items():
        out[d * block:(d + 1) * block] = src[s * block:(s + 1) * block]
    return out


def remap_coco_state_dict_to_cityscapes(coco_sd: dict, city_sd: dict,
                                        label_map: dict | None = None) -> dict:
    """Merge a COCO-trained state_dict into a Cityscapes-initialised one.
    Returns a new state_dict with the Cityscapes shapes."""
    label_map = label_map or CITYSCAPES_TO_COCO_LABEL
    out = {k: v.clone() for k, v in city_sd.items()}
    for k, v in coco_sd.items():
        if k in out and tuple(v.shape) == tuple(out[k].shape):
            out[k] = v.clone()
    for layer, block in CLASS_LAYERS.items():
        for leaf in ("weight", "bias"):
            key = f"{layer}.{leaf}"
            if key in coco_sd and key in out:
                out[key] = _remap_rows(coco_sd[key], out[key], label_map, block)
    # semantic score: stuff spaces differ (COCO 53 stuff + 80 things against
    # Cityscapes 11 + 8); only things map: city train id 11 + label - 1 from
    # coco train id 53 + coco_label - 1
    w_key, b_key = f"{SEG_SCORE}.weight", f"{SEG_SCORE}.bias"
    if w_key in coco_sd and w_key in out:
        w_src, b_src = coco_sd[w_key], coco_sd[b_key]
        w_dst, b_dst = out[w_key].clone(), out[b_key].clone()
        for d, s in ((11 + d - 1, 53 + s - 1) for d, s in label_map.items()):
            if s < w_src.shape[0] and d < w_dst.shape[0]:
                w_dst[d] = w_src[s]
                b_dst[d] = b_src[s]
        out[w_key], out[b_key] = w_dst, b_dst
    return out
