"""The single-device train step.

Port of the single-device half of ``upsnet_tpu/parallel/steps.py:
make_train_step``: forward, backward, global-norm gradient clip, scheduled
SGD update. The DCN layers take ``dcn_impl_train`` by themselves while
autograd records (``models/layers.py:DeformConv``). What the backward keeps
of the trunk follows ``train.remat`` and ``train.remat_policy``
(``models/remat.py``): every activation without remat, only the DCN layers'
sampled outputs under ``save_dcn`` (the default), nothing under full remat.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function

from upsnet_torch.config.defaults import Config
from upsnet_torch.models.upsnet import forward_train
from upsnet_torch.train.optimizer import sgd_update


def make_train_step(model: nn.Module, cfg: Config, anchors,
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator | None = None):
    """Returns ``step(batch, noise=None) -> metrics``: one optimisation step
    on ``model`` in place. ``metrics`` holds the 7 loss terms and ``total``
    as detached scalars on the model's device. ``noise`` is
    ``forward_train``'s; what it lacks is drawn from ``generator``. The
    schedule's step is the optimizer's update count (``optimizer.py``), which
    every step made over the same optimizer shares, one per image bucket, and
    which a checkpoint saves with the optimizer's state. Gradients are
    clipped to the global norm ``cfg.train.grad_clip`` over the trainable
    parameters."""

    def step(batch, noise=None):
        optimizer.zero_grad(set_to_none=True)
        total, losses = forward_train(model, cfg, anchors, batch, noise, generator)
        with record_function("train.backward"):
            total.backward()
        with record_function("train.update"):
            sgd_update(optimizer, cfg)
        return {**{k: v.detach() for k, v in losses.items()}, "total": total.detach()}

    return step
