"""The training loop over an iterator of batches (no data loader or
checkpoints yet).

Port of the hot loop of ``upsnet_tpu/train/trainer.py``: steps are queued
back to back with their loss scalars kept on the device; once per
``cfg.train.display_iter`` steps (and once for the tail) the loop reads them
(the one sync of the interval), averages them, logs, runs the DCN saturation
watch and appends one line to
``<cfg.output_path>/<cfg.symbol>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterable

from upsnet_torch.config.defaults import Config
from upsnet_torch.train.optimizer import make_optimizer
from upsnet_torch.train.step import make_train_step
from upsnet_torch.utils.dcn_probe import SaturationWatch, probe_dcn_offsets

logger = logging.getLogger(__name__)

# the train impls whose offset clip the loop watches: the JAX loop's
# condition, which leaves 'shift' unwatched
WATCHED_IMPLS = ("pallas", "mxu")


def train_steps(model, cfg: Config, anchors, batches: Iterable[dict],
                optimizer=None, generator=None, on_step=None) -> list[dict]:
    """Train ``model`` in place, one step per batch of ``batches`` (dicts of
    tensors on the model's device, ``forward_train``'s keys). Returns the
    per-step loss dicts as Python floats. ``optimizer`` defaults to
    ``make_optimizer(cfg, model)``; the random draws come from ``generator``.

    Nothing waits for the device inside a display interval. At its end the
    losses are read, ``on_step(i, metrics)`` is called for each of its steps
    in order, and one entry goes to ``metrics.jsonl`` with the JAX loop's
    fields: the interval's mean of each loss term and ``total``, ``iter``,
    ``images_per_sec``, ``step_s``, ``loader_wait_s`` (time spent waiting for
    ``batches``), ``platform`` and, when the train impl clips dy only
    ('pallas', 'mxu'), the watch's ``dcn_*`` fields from a probe of the
    trunk on the interval's last images. The watch acts on sustained
    saturation as ``cfg.network.dcn_saturation_action`` says ('fail' raises
    RuntimeError, 'warn' logs an error).
    """
    net = cfg.network
    if optimizer is None:
        optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, cfg, anchors, optimizer, generator=generator)
    impl_train = net.dcn_impl_train or net.dcn_impl
    uses_dcn = net.fcn_with_dcn or net.backbone_with_dcn
    sat_watch = None
    if uses_dcn and impl_train in WATCHED_IMPLS:
        sat_watch = SaturationWatch(net.dcn_max_dy, impl_train, net.dcn_boundary_grad,
                                    net.dcn_saturation_action)
    out_dir = os.path.join(cfg.output_path, cfg.symbol)
    os.makedirs(out_dir, exist_ok=True)
    metrics_path = os.path.join(out_dir, "metrics.jsonl")
    display_iter = max(int(cfg.train.display_iter), 1)

    history: list[dict] = []
    pending: list[dict] = []
    loader_wait_s = 0.0
    t0 = time.time()

    def flush_interval(last_batch):
        """Read the interval's losses (one sync), average them, log, run the
        saturation watch, append to metrics.jsonl."""
        nonlocal loader_wait_s, t0
        steps = [{k: float(v) for k, v in m.items()} for m in pending]
        pending.clear()
        first = len(history)
        history.extend(steps)
        means = {k: sum(m[k] for m in steps) / len(steps) for k in steps[0]}
        # the reads above waited for the whole interval, so wall minus the
        # wait for batches is step time
        wall = time.time() - t0
        rate = len(steps) * last_batch["images"].shape[0] / wall
        logger.info("iter %d (%.2f img/s; step %.2fs loader-wait %.2fs): %s",
                    len(history), rate, wall - loader_wait_s, loader_wait_s,
                    " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
        entry = means | {
            "iter": len(history), "images_per_sec": rate,
            "step_s": wall - loader_wait_s, "loader_wait_s": loader_wait_s,
            "platform": last_batch["images"].device.type,
        }
        if sat_watch is not None:
            fields, warning = sat_watch.update(
                probe_dcn_offsets(model, last_batch["images"]))
            entry.update(fields)
            if warning:
                logger.error(warning)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        if on_step is not None:
            for i, m in enumerate(steps, start=first):
                on_step(i, m)
        loader_wait_s = 0.0
        t0 = time.time()

    it = iter(batches)
    try:
        while True:
            t_wait = time.time()
            nxt = next(it, None)
            loader_wait_s += time.time() - t_wait
            if nxt is None:
                break
            batch = nxt
            pending.append(step(batch))
            if len(pending) >= display_iter:
                flush_interval(batch)
    finally:
        # the tail of a run that ends inside an interval is still metered,
        # watched and streamed
        if pending:
            flush_interval(batch)
    return history
