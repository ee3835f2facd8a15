"""Optimizer and LR schedule.

Port of ``upsnet_tpu/train/optimizer.py``: SGD with momentum 0.9 (no
Nesterov, no dampening), weight decay added to the gradient before the
momentum (optax's ``add_decayed_weights`` ahead of ``sgd``, which is the
order of ``torch.optim.SGD(weight_decay=...)``), and the reference's
per-parameter rules as param groups:

  weight       lr x 1, weight decay
  bias         biases and GroupNorm scales: lr x 2, no weight decay
               (Detectron convention; the JAX labels under GN)
  offset       DCN offset-conv weights: lr x ``dcn_offset_lr_mult``, decay
  offset_bias  DCN offset-conv biases: the same damped lr, no decay

Frozen parameters (``requires_grad`` False: the backbone's stem and res2)
are left out; FrozenBN affines are buffers. The schedule is linear warmup
from ``warmup_factor`` over ``warmup_iteration`` steps times a multi-step
decay.
"""

from __future__ import annotations

import torch
from torch import nn

from upsnet_torch.config.defaults import Config

GROUPS = ("weight", "bias", "offset", "offset_bias")


def lr_schedule(cfg: Config):
    """step -> learning rate of the ``weight`` group."""
    tc = cfg.train

    def sched(step: int) -> float:
        warm = tc.warmup_factor + (1.0 - tc.warmup_factor) * min(
            step / max(tc.warmup_iteration, 1), 1.0)
        decay = 1.0
        for boundary in tc.decay_iteration:
            if step >= int(boundary):
                decay *= tc.decay_factor
        return tc.lr * warm * decay

    return sched


def param_label(name: str) -> str:
    """The group of the trainable parameter ``name`` (a state_dict key)."""
    if "offset_conv" in name:
        return "offset_bias" if name.endswith(".bias") else "offset"
    # a parameter named scale is a GroupNorm affine (FrozenBN's are buffers)
    return "bias" if name.endswith((".bias", ".scale")) else "weight"


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.SGD:
    """SGD over the trainable parameters of ``model`` in the four groups.
    Each group carries ``name`` and ``lr_mult``; ``sgd_update`` applies the
    schedule."""
    tc = cfg.train
    rules = {"weight": (1.0, tc.wd), "bias": (2.0, 0.0),
             "offset": (tc.dcn_offset_lr_mult, tc.wd),
             "offset_bias": (tc.dcn_offset_lr_mult, 0.0)}
    members = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if p.requires_grad:
            members[param_label(name)].append(p)
    base = lr_schedule(cfg)(0)
    groups = [{"params": members[g], "name": g, "lr_mult": rules[g][0],
               "lr": base * rules[g][0], "weight_decay": rules[g][1]}
              for g in GROUPS if members[g]]
    return torch.optim.SGD(groups, lr=base, momentum=tc.momentum, dampening=0.0,
                           nesterov=False)


def sgd_update(optimizer: torch.optim.Optimizer, cfg: Config, step: int) -> None:
    """One update from the gradients the parameters hold: clip them to the
    global norm ``cfg.train.grad_clip`` (over the optimizer's parameters),
    give every group the schedule's rate at ``step`` times its ``lr_mult``,
    and step."""
    if cfg.train.grad_clip > 0:
        params = [p for group in optimizer.param_groups for p in group["params"]]
        nn.utils.clip_grad_norm_(params, cfg.train.grad_clip)
    lr = lr_schedule(cfg)(step)
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
    optimizer.step()
