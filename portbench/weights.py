"""Weights from the seed, made on the device in a few large draws.

The benchmark, not the program, makes every weight: the program's state
dict gives the names and shapes (its checkpoint layout), and each tensor is
filled by a rule of its name, from one ``torch.Generator`` on the device:

- conv and deconv weights He-normal over their fan-in, dense weights
  ``fan_in ** -0.5``; the RPN head's at ``rpn_std`` and the box head's
  class scores and box deltas at ``cls_score_std`` and ``bbox_pred_std``
  (Detectron's Gaussian init of these heads: 0.01, 0.01, 0.001);
- offset-conv weights zero and their biases uniform in +-``offset_bias_px``
  (the program's ``chip_smoke.py:perturb_offset_biases``), so every
  deformable conv samples at fractional positions as a trained one does;
- frozen-BN scales uniform in ``bn_scale`` (``chip_smoke.py:
  shrink_bn_scales``), below 1 as pretrained statistics give them, so
  activations stay of order one through the random trunk;
- every bias zero.

The same seed gives the same tensors; the reference gets them by calling
``make_state`` again after the program is freed.
"""

from __future__ import annotations

import math

import torch


def _kind(name: str, shape) -> str:
    if name.endswith("offset_conv.weight"):
        return "zero"
    if name.endswith("offset_conv.bias"):
        return "offset"
    if name.endswith(".scale"):
        return "bn_scale"
    if name.endswith(".weight") and len(shape) >= 2:
        return "normal"
    return "zero"


def _std(name: str, shape, wcfg: dict) -> float:
    if name.startswith("rpn.") and "rpn_std" in wcfg:
        return float(wcfg["rpn_std"])
    if name.endswith("box_head.cls_score.weight"):
        return float(wcfg["cls_score_std"])
    if name.endswith("box_head.bbox_pred.weight"):
        return float(wcfg["bbox_pred_std"])
    fan_in = shape[1] * math.prod(shape[2:])
    return math.sqrt(2.0 / fan_in) if len(shape) == 4 else fan_in ** -0.5


def make_state(shapes: dict, wcfg: dict, seed: int, device) -> dict:
    """``shapes``: name -> shape (every float tensor of the state dict).
    Returns name -> float32 tensor on ``device``: one normal draw, one
    uniform draw for the offset biases, one for the BN scales."""
    names = sorted(shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    groups = {"normal": [], "offset": [], "bn_scale": [], "zero": []}
    for n in names:
        groups[_kind(n, shapes[n])].append(n)
    out = {}
    sizes = [math.prod(shapes[n]) for n in groups["normal"]]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    for n, part in zip(groups["normal"], torch.split(flat, sizes)):
        out[n] = part.reshape(shapes[n]) * _std(n, shapes[n], wcfg)
    sizes = [math.prod(shapes[n]) for n in groups["offset"]]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    px = float(wcfg["offset_bias_px"])
    for n, part in zip(groups["offset"], torch.split(flat, sizes)):
        out[n] = part.reshape(shapes[n]) * px  # dy and dx alike
    lo, hi = wcfg["bn_scale"]
    sizes = [math.prod(shapes[n]) for n in groups["bn_scale"]]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * (hi - lo) + lo
    for n, part in zip(groups["bn_scale"], torch.split(flat, sizes)):
        out[n] = part.reshape(shapes[n])
    for n in groups["zero"]:
        out[n] = torch.zeros(shapes[n], device=device)
    return out


def state_shapes(model: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items() if v.is_floating_point()}
