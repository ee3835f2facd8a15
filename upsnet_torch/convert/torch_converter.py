"""Reference PyTorch checkpoints -> the port's state dict.

The port's own copy of ``upsnet_tpu/convert/torch_converter.py``. It loads
released UPSNet ``.pth`` checkpoints, and torchvision-style caffe-ResNet
ImageNet weights for the backbone (SURVEY.md §5.4), into the port's module
tree. The port keeps torch layouts, so most tensors pass as they are:

  * conv, deformable conv (OIHW), its offset conv, dense (out, in) and the
    mask head's ConvTranspose (in, out, kh, kw): unchanged;
  * the box head's fc1 on flattened RoI features: the reference flattens
    (C, P, P), the port (P, P, C) (``models/heads.py``), so its weight is
    un-flattened, permuted and re-flattened (``fc_flat_w``);
  * BatchNorm: folded to the FrozenBN affines ``scale`` and ``bias``,
    ``scale = gamma / sqrt(running_var + eps)``, ``bias = beta - mean *
    scale``, in float32 numpy as the JAX converter folds them.

Two naming schemes: full UPSNet names go through the strict name map of
``convert/upsnet_names.py``; torchvision ResNet names fill the backbone
only (``torchvision_resnet_to_backbone``), the heads keeping their init.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

BN_EPS = 1e-5


def _fold_bn(gamma, beta, mean, var, eps=BN_EPS):
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def fc_flat_w(w: np.ndarray, p: int) -> np.ndarray:
    """(out, C*P*P) over (C, P, P)-flattened features -> (out, P*P*C)."""
    o = w.shape[0]
    c = w.shape[1] // (p * p)
    return np.ascontiguousarray(np.transpose(w.reshape(o, c, p, p), (0, 2, 3, 1)).reshape(o, -1))


def torchvision_resnet_to_backbone(state: dict, depth: str = "resnet50") -> dict:
    """torchvision ResNet state_dict -> the port's ``backbone_net.*`` entries
    (numpy float32), BN folded into the FrozenBN affines.

    torchvision ResNet puts the downsampling stride on the 3x3 conv (v1.5);
    caffe-style UPSNet weights put it on the first 1x1, which is what the
    model implements. torchvision weights still load (the shapes match) but
    are v1.5-trained; converted caffe weights are preferred for parity runs.
    """
    blocks = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}[depth]
    out: dict = {}

    def f32(key):
        return np.asarray(state[key], np.float32)

    def bn(src, dst):
        out[f"{dst}.scale"], out[f"{dst}.bias"] = _fold_bn(
            f32(f"{src}.weight"), f32(f"{src}.bias"), f32(f"{src}.running_mean"),
            f32(f"{src}.running_var"))

    out["backbone_net.conv1.weight"] = f32("conv1.weight")
    bn("bn1", "backbone_net.bn1")
    for stage_i, n in enumerate(blocks, start=2):
        layer = f"layer{stage_i - 1}"
        for bi in range(n):
            dst = f"backbone_net.res{stage_i}_{bi}"
            for ci in (1, 2, 3):
                out[f"{dst}.conv{ci}.weight"] = f32(f"{layer}.{bi}.conv{ci}.weight")
                bn(f"{layer}.{bi}.bn{ci}", f"{dst}.bn{ci}")
            if f"{layer}.{bi}.downsample.0.weight" in state:
                out[f"{dst}.shortcut_conv.weight"] = f32(f"{layer}.{bi}.downsample.0.weight")
                bn(f"{layer}.{bi}.downsample.1", f"{dst}.shortcut_bn")
    return out


def load_torch_state(path: str) -> dict:
    """The tensors of a torch checkpoint as numpy arrays by name: the file is
    read with ``torch.load(weights_only=True)`` (tensors and plain
    containers, no code), a ``state_dict`` entry is unwrapped and DDP's
    ``module.`` prefix stripped. A file that cannot be read that way is
    refused by name."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except FileNotFoundError:
        raise
    except Exception as e:  # noqa: BLE001 - re-raised with the reason
        raise ValueError(f"{path}: cannot be read with torch.load(weights_only=True) "
                         f"({type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}); "
                         "the port loads tensors only, not pickled code") from e
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: holds a {type(obj).__name__}, not a state dict")
    return {
        re.sub(r"^module\.", "", k): v.numpy() if isinstance(v, torch.Tensor) else v
        for k, v in obj.items()
    }


def load_pretrained(path: str, model: torch.nn.Module,
                    logger: logging.Logger | None = None) -> None:
    """Load a torch checkpoint into ``model`` in place, dispatching on its
    naming scheme (the JAX ``load_pretrained``):

      * a full UPSNet state dict -> the strict name map
        (``upsnet_names.convert_upsnet_state``: every target unit fed,
        every source key consumed, or ``ConversionError``);
      * a torchvision ResNet -> the backbone only (ImageNet init; the heads
        keep their init); a converted tensor the model lacks, or of another
        shape, raises.

    Both are strict (the JAX function's default); ``tools/convert_report.py``
    lists what a strict load would refuse."""
    from upsnet_torch.convert.upsnet_names import convert_upsnet_state, looks_like_upsnet

    state = load_torch_state(path)
    target = model.state_dict()
    if looks_like_upsnet(state):
        merged, report = convert_upsnet_state(state, target)
        model.load_state_dict(merged, strict=True)
        if logger:
            logger.info("UPSNet checkpoint %s: loaded %d units, %d missing, %d leftover, "
                        "defaulted %s", path, len(report["loaded"]), len(report["missing"]),
                        len(report["leftover"]), report["defaulted"] or "none")
        return

    depth = "resnet101" if any(k.startswith("layer3.22") for k in state) else "resnet50"
    backbone = torchvision_resnet_to_backbone(state, depth)
    problems, loaded = [], {}
    for k, v in backbone.items():
        if k not in target:
            problems.append(f"converted {k} absent from the model")
        elif tuple(v.shape) != tuple(target[k].shape):
            problems.append(f"shape mismatch at {k}: {v.shape} vs {tuple(target[k].shape)}")
        else:
            loaded[k] = torch.from_numpy(v).to(target[k].dtype)
    if problems:
        raise RuntimeError(f"torchvision backbone load from {path} incomplete:\n  "
                           + "\n  ".join(problems))
    model.load_state_dict({**target, **loaded}, strict=True)
    if logger:
        logger.info("loaded %d backbone tensors from %s (heads keep their init)", len(loaded),
                    path)
