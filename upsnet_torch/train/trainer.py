"""The training loop over an iterator of batches (no data loader,
checkpoints or offset-saturation watch yet)."""

from __future__ import annotations

from typing import Iterable

from upsnet_torch.config.defaults import Config
from upsnet_torch.train.optimizer import make_optimizer
from upsnet_torch.train.step import make_train_step


def train_steps(model, cfg: Config, anchors, batches: Iterable[dict],
                optimizer=None, generator=None, on_step=None) -> list[dict]:
    """Train ``model`` in place, one step per batch of ``batches`` (dicts of
    tensors on the model's device, ``forward_train``'s keys). Returns the
    per-step loss dicts as Python floats (each read waits for its step).
    ``optimizer`` defaults to ``make_optimizer(cfg, model)``; the random
    draws come from ``generator``; ``on_step(i, metrics)`` is called after
    each step."""
    if optimizer is None:
        optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, cfg, anchors, optimizer, generator=generator)
    history = []
    for i, batch in enumerate(batches):
        metrics = {k: float(v) for k, v in step(batch).items()}
        history.append(metrics)
        if on_step is not None:
            on_step(i, metrics)
    return history
