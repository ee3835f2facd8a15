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

import numpy as np
import torch
from torch import nn

from upsnet_torch.config.defaults import Config

GROUPS = ("weight", "bias", "offset", "offset_bias")


def lr_schedule(cfg: Config):
    """step -> learning rate of the ``weight`` group, in float32 arithmetic
    in the JAX schedule's order (optax evaluates it on the int32 count with
    float32 ops), so that the rate equals the JAX package's."""
    tc = cfg.train
    f32 = np.float32

    def sched(step: int) -> float:
        frac = np.minimum(f32(step) / f32(max(tc.warmup_iteration, 1)), f32(1.0))
        warm = f32(tc.warmup_factor) + f32(1.0 - tc.warmup_factor) * frac
        decay = f32(1.0)
        for boundary in tc.decay_iteration:
            decay = decay * (f32(tc.decay_factor) if step >= int(boundary) else f32(1.0))
        return float(f32(tc.lr) * warm * decay)

    return sched


def param_label(name: str) -> str:
    """The group of the trainable parameter ``name`` (a state_dict key)."""
    if "offset_conv" in name:
        return "offset_bias" if name.endswith(".bias") else "offset"
    # a parameter named scale is a GroupNorm affine (FrozenBN's are buffers)
    return "bias" if name.endswith((".bias", ".scale")) else "weight"


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.SGD:
    """SGD over the trainable parameters of ``model`` in the four groups.
    Each group carries ``name``, ``lr_mult`` and ``count``, the number of
    updates taken (optax's count), which ``optimizer.state_dict()`` saves and
    ``load_state_dict`` restores; ``sgd_update`` applies the schedule at it."""
    tc = cfg.train
    rules = {"weight": (1.0, tc.wd), "bias": (2.0, 0.0),
             "offset": (tc.dcn_offset_lr_mult, tc.wd),
             "offset_bias": (tc.dcn_offset_lr_mult, 0.0)}
    members = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if p.requires_grad:
            members[param_label(name)].append(p)
    base = lr_schedule(cfg)(0)
    groups = [{"params": members[g], "name": g, "lr_mult": rules[g][0], "count": 0,
               "lr": base * rules[g][0], "weight_decay": rules[g][1]}
              for g in GROUPS if members[g]]
    return torch.optim.SGD(groups, lr=base, momentum=tc.momentum, dampening=0.0,
                           nesterov=False)


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates ``optimizer`` has taken: the schedule's step."""
    return int(optimizer.param_groups[0]["count"])


def sgd_update(optimizer: torch.optim.Optimizer, cfg: Config, step: int | None = None) -> float:
    """One update from the gradients the parameters hold: clip them to the
    global norm ``cfg.train.grad_clip`` (over the optimizer's parameters),
    give every group the schedule's rate at the optimizer's update count
    times its ``lr_mult``, step, and count the update. Returns the schedule's
    rate. A caller that keeps its own ``step`` passes it to have it checked
    against the count."""
    if step is not None and step != update_count(optimizer):
        raise ValueError(f"sgd_update: step {step}, but the optimizer has taken "
                         f"{update_count(optimizer)} updates")
    if cfg.train.grad_clip > 0:
        params = [p for group in optimizer.param_groups for p in group["params"]]
        nn.utils.clip_grad_norm_(params, cfg.train.grad_clip)
    lr = lr_schedule(cfg)(update_count(optimizer))
    for group in optimizer.param_groups:  # float32, as optax scales the schedule
        group["lr"] = float(np.float32(lr) * np.float32(group["lr_mult"]))
    optimizer.step()
    for group in optimizer.param_groups:
        group["count"] += 1
    return lr
