"""Full UPSNet ``.pth`` state dict -> the port's state dict, by name.

The port's own copy of ``upsnet_tpu/convert/upsnet_names.py``: the same
declarative spec table, the same candidate source names per unit, the same
strictness, mapped onto the port's module names (which follow the JAX
parameter tree name for name: ``backbone_net.res2_0.conv1``,
``fpn.lateral2``, ``fcn_head.subnet.dcn1.offset_conv``, ...). Reference
naming follows ``upsnet/models/resnet_upsnet.py`` and its submodules
(SURVEY.md §2.3, §5.4): ``resnet_backbone.*``, ``fpn.fpn_p{i}[_1x1]``,
``rpn.*``, ``rcnn.*``, ``mask_branch.*``, ``fcn_head.*``.

Conversion is STRICT both ways by default:

  * every target unit must be fed by some source key, and
  * every source key must be consumed (or be a known non-parameter),

otherwise ``ConversionError`` is raised with the full lists. Layouts are
``convert/torch_converter.py``'s: torch layouts pass unchanged, fc1 is
re-flattened from (C, P, P) to (P, P, C), BatchNorm is folded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from upsnet_torch.convert.torch_converter import _fold_bn, fc_flat_w

# Source keys that are legitimately not parameters of this model.
_IGNORABLE_SUFFIXES = ("num_batches_tracked",)
_IGNORABLE_PREFIXES = ("optimizer", "lr_scheduler", "iteration", "iter", "epoch")


class ConversionError(RuntimeError):
    pass


@dataclasses.dataclass
class Spec:
    """One target unit (a conv/dense/bn/... module) to fill."""

    target: tuple  # module path, e.g. ("fpn", "lateral2")
    kind: str  # conv | dense | dense_flat | deconv | deform | bn | offset
    sources: list  # candidate source prefixes (module names w/o .weight)
    has_bias: bool = True
    optional_bias: bool = False  # fill zeros if the source has no bias
    flat_hw: int = 0  # dense_flat: spatial P of the pooled grid


def state_tree(state: dict) -> dict:
    """A flat state dict as nested dicts of its module path."""
    tree: dict = {}
    for key, value in state.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _backbone_specs(backbone: dict) -> list:
    sp = [
        Spec(("backbone_net", "conv1"), "conv",
             ["resnet_backbone.conv1.conv1", "resnet_backbone.conv1",
              "conv1"], has_bias=False),
        Spec(("backbone_net", "bn1"), "bn",
             ["resnet_backbone.conv1.bn1", "resnet_backbone.bn1", "bn1"]),
    ]
    for name, blk in backbone.items():
        if not name.startswith("res"):
            continue
        stage, b = name[3:].split("_")
        pref = [f"resnet_backbone.res{stage}.{b}"]
        for ci in (1, 2, 3):
            if ci == 2 and "offset_conv" in blk.get("conv2", {}):
                sp.append(Spec(("backbone_net", name, "conv2"), "deform",
                               [f"{p}.conv2" for p in pref], has_bias=False))
                sp.append(Spec(
                    ("backbone_net", name, "conv2", "offset_conv"), "offset",
                    [f"{p}.conv2_offset" for p in pref]
                    + [f"{p}.conv2.conv_offset" for p in pref]))
            else:
                sp.append(Spec(("backbone_net", name, f"conv{ci}"), "conv",
                               [f"{p}.conv{ci}" for p in pref],
                               has_bias=False))
            sp.append(Spec(("backbone_net", name, f"bn{ci}"), "bn",
                           [f"{p}.bn{ci}" for p in pref]))
        if "shortcut_conv" in blk:
            sp.append(Spec(("backbone_net", name, "shortcut_conv"), "conv",
                           [f"{p}.downsample.0" for p in pref]
                           + [f"{p}.shortcut" for p in pref], has_bias=False))
            sp.append(Spec(("backbone_net", name, "shortcut_bn"), "bn",
                           [f"{p}.downsample.1" for p in pref]
                           + [f"{p}.shortcut_bn" for p in pref]))
    return sp


def _head_specs(tree: dict, pooled_size_box: int = 7) -> list:
    sp = []
    # FPN: lateral{i} <- fpn_p{i}_1x1, output{i} <- fpn_p{i}
    for tgt in sorted(tree["fpn"]):
        i = tgt[-1]
        if tgt.startswith("lateral"):
            sp.append(Spec(("fpn", tgt), "conv", [f"fpn.fpn_p{i}_1x1"]))
        else:
            sp.append(Spec(("fpn", tgt), "conv", [f"fpn.fpn_p{i}"]))
    # RPN (reference wraps the 3x3 in a Sequential with its ReLU)
    sp += [
        Spec(("rpn", "conv"), "conv",
             ["rpn.conv_proposal.0", "rpn.conv_proposal", "rpn.conv"]),
        Spec(("rpn", "cls_score"), "conv",
             ["rpn.cls_score", "rpn.cls_prob"]),
        Spec(("rpn", "bbox_pred"), "conv", ["rpn.bbox_pred"]),
    ]
    # RCNN box head (Detectron-lineage fc6/fc7 naming)
    sp += [
        Spec(("box_head", "fc1"), "dense_flat",
             ["rcnn.fc6", "rcnn.fc1"], flat_hw=pooled_size_box),
        Spec(("box_head", "fc2"), "dense", ["rcnn.fc7", "rcnn.fc2"]),
        Spec(("box_head", "cls_score"), "dense", ["rcnn.cls_score"]),
        Spec(("box_head", "bbox_pred"), "dense", ["rcnn.bbox_pred"]),
    ]
    # mask branch
    for tgt in sorted(tree["mask_head"]):
        if tgt.startswith("conv"):
            i = tgt[4:]
            sp.append(Spec(("mask_head", tgt), "conv",
                           [f"mask_branch.mask_conv{i}",
                            f"mask_branch.mask_conv{i}.0",
                            f"mask_branch.conv{i}"]))
    sp += [
        Spec(("mask_head", "deconv"), "deconv",
             ["mask_branch.mask_deconv", "mask_branch.mask_deconv.0",
              "mask_branch.upsample"]),
        Spec(("mask_head", "mask_score"), "conv",
             ["mask_branch.mask_score", "mask_branch.score"]),
    ]

    # FCN semantic head: shared subnet (ModuleList `conv.{i}` naming first,
    # flat `conv{i+1}` alternate) + its zero-init offset convs + 1x1 score.
    def subnet_specs(tgt_sub: str, src_sub: str):
        out = []
        sub = tree["fcn_head"][tgt_sub]
        for name in sorted(sub):
            if name.startswith("dcn"):
                i = int(name[3:]) - 1
                out.append(Spec(
                    ("fcn_head", tgt_sub, name), "deform",
                    [f"fcn_head.{src_sub}.conv.{i}",
                     f"fcn_head.{src_sub}.conv{i + 1}"],
                    optional_bias=True))
                out.append(Spec(
                    ("fcn_head", tgt_sub, name, "offset_conv"), "offset",
                    [f"fcn_head.{src_sub}.conv_offset.{i}",
                     f"fcn_head.{src_sub}.conv.{i}_offset",
                     f"fcn_head.{src_sub}.conv{i + 1}_offset"]))
            elif name.startswith("conv"):
                i = int(name[4:]) - 1
                out.append(Spec(("fcn_head", tgt_sub, name), "conv",
                                [f"fcn_head.{src_sub}.conv.{i}",
                                 f"fcn_head.{src_sub}.conv{i + 1}"]))
        return out

    for tgt_sub in sorted(k for k in tree["fcn_head"] if k.startswith("subnet")):
        # shared subnet == "subnet"; per-level == subnet2..5 (fcn_subnet_p{i})
        src = "fcn_subnet" if tgt_sub == "subnet" else f"fcn_subnet_p{tgt_sub[6:]}"
        sp += subnet_specs(tgt_sub, src)
    sp.append(Spec(("fcn_head", "score"), "conv",
                   ["fcn_head.score", "fcn_head.fcn_score",
                    "fcn_head.conv_pred", "fcn_head.seg_score"]))
    return sp


def build_specs(target: dict) -> list:
    """The spec table for the port model whose state dict is ``target``."""
    tree = state_tree(target)
    fan_in = tuple(tree["box_head"]["fc1"]["weight"].shape)[1]
    # infer pooled P from fc1's in-dim = P*P*C with C a multiple of 256
    p = 7 if fan_in % 49 == 0 else int(np.sqrt(fan_in // 256))
    return _backbone_specs(tree["backbone_net"]) + _head_specs(tree, p)


def _apply(spec: Spec, state: dict, src: str, unit: dict) -> dict:
    """The unit's converted tensors (numpy float32) by leaf name."""
    w = np.asarray(state[f"{src}.weight"], np.float32)
    out = {}
    if spec.kind == "bn":
        out["scale"], out["bias"] = _fold_bn(
            w,
            np.asarray(state[f"{src}.bias"], np.float32),
            np.asarray(state[f"{src}.running_mean"], np.float32),
            np.asarray(state[f"{src}.running_var"], np.float32),
        )
        return out
    if spec.kind in ("conv", "offset", "dense", "deconv", "deform"):
        out["weight"] = w
    elif spec.kind == "dense_flat":
        out["weight"] = fc_flat_w(w, spec.flat_hw)
    else:
        raise ValueError(spec.kind)
    if "bias" in unit:
        if f"{src}.bias" in state:
            out["bias"] = np.asarray(state[f"{src}.bias"], np.float32)
        elif spec.optional_bias:
            out["bias"] = np.zeros(tuple(unit["bias"].shape), np.float32)
        else:
            raise ConversionError(
                f"{'.'.join(spec.target)}: source {src} has no bias but the "
                "target expects one")
    return out


def _consumed_keys(spec: Spec, state: dict, src: str) -> list:
    if spec.kind == "bn":
        keys = [f"{src}.{s}" for s in
                ("weight", "bias", "running_mean", "running_var")]
    else:
        keys = [f"{src}.weight"]
        if f"{src}.bias" in state:
            keys.append(f"{src}.bias")
    return keys


def convert_upsnet_state(state: dict, target: dict, *, strict: bool = True):
    """Map a full UPSNet state dict (name -> array) onto the port model
    whose state dict is ``target``. Returns (a state dict with every
    converted tensor in place, in the target's dtypes; report). Raises
    ConversionError (strict) on any unmapped target unit, leftover source
    key, or shape mismatch."""
    specs = build_specs(target)
    tree = state_tree(target)
    merged = dict(target)
    consumed: set = set()
    missing, shape_errors, loaded, defaulted = [], [], [], []
    for spec in specs:
        src = next(
            (s for s in spec.sources
             if f"{s}.weight" in state
             and (spec.kind != "bn" or f"{s}.running_mean" in state)),
            None,
        )
        unit = tree
        for k in spec.target:
            unit = unit[k]
        if src is None:
            missing.append(".".join(spec.target)
                           + f"  (tried: {', '.join(spec.sources)})")
            continue
        converted = _apply(spec, state, src, unit)
        prefix = ".".join(spec.target)
        for name, arr in converted.items():
            want = tuple(unit[name].shape)
            if arr.shape != want:
                shape_errors.append(
                    f"{prefix}.{name}: source {src} gives {arr.shape}, target wants {want}")
            else:
                merged[f"{prefix}.{name}"] = torch.from_numpy(arr).to(unit[name].dtype)
        consumed.update(_consumed_keys(spec, state, src))
        if spec.optional_bias and f"{src}.bias" not in state and "bias" in converted:
            defaulted.append(prefix + ".bias")
        loaded.append(prefix)
    leftover = [
        k for k in state
        if k not in consumed
        and not k.endswith(_IGNORABLE_SUFFIXES)
        and not k.startswith(_IGNORABLE_PREFIXES)
    ]
    report = {
        "loaded": loaded,
        "missing": missing,
        "leftover": sorted(leftover),
        "shape_errors": shape_errors,
        "defaulted": defaulted,
    }
    if strict and (missing or leftover or shape_errors):
        raise ConversionError(
            "UPSNet checkpoint conversion incomplete:\n"
            + "".join(f"  MISSING target {m}\n" for m in missing)
            + "".join(f"  LEFTOVER source {k}\n" for k in report["leftover"])
            + "".join(f"  SHAPE {s}\n" for s in shape_errors)
        )
    return merged, report


def looks_like_upsnet(state: dict) -> bool:
    return any(k.startswith(("resnet_backbone.", "fpn.fpn_", "rcnn.",
                             "mask_branch.", "fcn_head.")) for k in state)
