"""The training loop and the training entry.

Port of ``upsnet_tpu/train/trainer.py``. Steps are queued back to back with
their loss scalars kept on the device; once per ``cfg.train.display_iter``
steps (and once for the tail) the loop reads them (the one sync of the
interval), averages them, logs, runs the DCN saturation watch and appends
one line to ``<cfg.output_path>/<cfg.symbol>/metrics.jsonl``.

``train_steps`` runs that loop over batches the caller builds. ``train``
is the reference's whole entry: model, pretrained weights, optimizer,
resume, the loader over a dataset and the device prefetch, the loop, and
snapshots every ``snapshot_step`` iterations; under a process group
(``parallel/mesh.py``) each rank trains its share of the joined batch
through the data-parallel step (``parallel/steps.py``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterable

import torch

from upsnet_torch.config.defaults import Config
from upsnet_torch.convert.finetune import is_class_dependent, remap_coco_state_dict_to_cityscapes
from upsnet_torch.convert.torch_converter import load_pretrained
from upsnet_torch.data.pipeline import make_loader
from upsnet_torch.data.wire import DevicePrefetcher, decode_batch
from upsnet_torch.evaluation.inference import bucket_anchors
from upsnet_torch.models.registry import get_model
from upsnet_torch.parallel import steps as ddp_steps
from upsnet_torch.parallel.mesh import Group
from upsnet_torch.train.checkpoints import (
    CheckpointMismatch,
    latest_checkpoint,
    read_state_dict,
    restore_checkpoint,
    save_checkpoint,
)
from upsnet_torch.train.optimizer import lr_schedule, make_optimizer, update_count
from upsnet_torch.train.step import make_train_step
from upsnet_torch.utils.dcn_probe import SaturationWatch, probe_dcn_offsets
from upsnet_torch.utils.logging import create_logger

logger = logging.getLogger(__name__)

# the train impls whose offset clip the loop watches: the JAX loop's
# condition, which leaves 'shift' unwatched
WATCHED_IMPLS = ("pallas", "mxu")


class IntervalLog:
    """A display interval's bookkeeping: the steps' loss scalars, still on
    the device, the time spent waiting for batches, and at the end of the
    interval the line of ``metrics.jsonl`` with the JAX loop's fields: the
    interval's mean of each loss term and ``total``, ``iter``,
    ``images_per_sec``, ``step_s``, ``loader_wait_s``, ``platform`` and,
    when the train impl clips dy only ('pallas', 'mxu'), the watch's
    ``dcn_*`` fields from a probe of the trunk on the interval's last images.
    The watch acts on sustained saturation as
    ``cfg.network.dcn_saturation_action`` says ('fail' raises RuntimeError,
    'warn' logs an error).

    Under a process group (``group``) the losses are already the joined
    batch's, the rate counts every rank's images, the probe's statistics
    are the maximum over the ranks (so every rank takes the same decision:
    a rank that raised alone would hang the others), and rank 0 alone writes
    ``metrics.jsonl``."""

    def __init__(self, model, cfg: Config, log: logging.Logger, group: Group | None = None):
        net = cfg.network
        self.model, self.log = model, log
        self.group = group or Group()
        impl_train = net.dcn_impl_train or net.dcn_impl
        self.sat_watch = None
        if (net.fcn_with_dcn or net.backbone_with_dcn) and impl_train in WATCHED_IMPLS:
            self.sat_watch = SaturationWatch(net.dcn_max_dy, impl_train,
                                             net.dcn_boundary_grad,
                                             net.dcn_saturation_action)
        out_dir = os.path.join(cfg.output_path, cfg.symbol)
        os.makedirs(out_dir, exist_ok=True)
        self.metrics_path = os.path.join(out_dir, "metrics.jsonl")
        self.pending: list[dict] = []
        self.loader_wait_s = 0.0
        self.t0 = time.time()

    def next_batch(self, it):
        """``next(it, None)``, timed as waiting for the loader."""
        t = time.time()
        nxt = next(it, None)
        self.loader_wait_s += time.time() - t
        return nxt

    def flush(self, it: int, last_images: torch.Tensor) -> tuple[dict, list[dict]]:
        """Read the interval's losses (one sync), average them, log, run the
        saturation watch, append to metrics.jsonl. ``it`` is the iteration
        the interval ends at. Returns (the line, the steps' losses as
        floats)."""
        steps = [{k: float(v) for k, v in m.items()} for m in self.pending]
        self.pending.clear()
        means = {k: sum(m[k] for m in steps) / len(steps) for k in steps[0]}
        # the reads above waited for the whole interval, so wall minus the
        # wait for batches is step time
        wall = time.time() - self.t0
        rate = len(steps) * last_images.shape[0] * self.group.world / wall
        self.log.info("iter %d (%.2f img/s; step %.2fs loader-wait %.2fs): %s",
                      it, rate, wall - self.loader_wait_s, self.loader_wait_s,
                      " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
        entry = means | {
            "iter": it, "images_per_sec": rate,
            "step_s": wall - self.loader_wait_s, "loader_wait_s": self.loader_wait_s,
            "platform": last_images.device.type,
        }
        if self.sat_watch is not None:
            stats = self.group.max_stats(probe_dcn_offsets(self.model, last_images))
            fields, warning = self.sat_watch.update(stats)
            entry.update(fields)
            if warning:
                self.log.error(warning)
        if self.group.is_main:
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(entry) + "\n")
        self.loader_wait_s = 0.0
        self.t0 = time.time()
        return entry, steps


def train_steps(model, cfg: Config, anchors, batches: Iterable[dict],
                optimizer=None, generator=None, on_step=None) -> list[dict]:
    """Train ``model`` in place, one step per batch of ``batches`` (dicts of
    tensors on the model's device, ``forward_train``'s keys). Returns the
    per-step loss dicts as Python floats. ``optimizer`` defaults to
    ``make_optimizer(cfg, model)``; the random draws come from ``generator``.

    Nothing waits for the device inside a display interval. At its end the
    losses are read, one line goes to ``metrics.jsonl`` (``IntervalLog``; its
    ``iter`` counts the steps of this call) and ``on_step(i, metrics)`` is
    called for each of the interval's steps in order.
    """
    if optimizer is None:
        optimizer = make_optimizer(cfg, model)
    step = make_train_step(model, cfg, anchors, optimizer, generator=generator)
    log = IntervalLog(model, cfg, logger)
    display_iter = max(int(cfg.train.display_iter), 1)
    history: list[dict] = []

    def flush(last_batch):
        first = len(history)
        _, steps = log.flush(first + len(log.pending), last_batch["images"])
        history.extend(steps)
        if on_step is not None:
            for i, m in enumerate(steps, start=first):
                on_step(i, m)

    it = iter(batches)
    batch = None
    try:
        while (nxt := log.next_batch(it)) is not None:
            batch = nxt
            log.pending.append(step(batch))
            if len(log.pending) >= display_iter:
                flush(batch)
    finally:
        # the tail of a run that ends inside an interval is still metered,
        # watched and streamed
        if log.pending:
            flush(batch)
    return history


def load_pretrained_any(path: str, model, log: logging.Logger) -> None:
    """Load ``network.pretrained`` into ``model`` with the reference's
    fine-tune semantics (the JAX ``load_pretrained_any``):

      * a ``.../latest`` tail resolves to the newest ``step_*`` beside it;
      * a port snapshot whose names and shapes equal the model's loads as it
        is; one that differs only in the class-dependent final layers (a COCO
        model for a Cityscapes config) goes through the COCO -> Cityscapes
        head remap (``convert/finetune.py``); any other difference raises
        ``CheckpointMismatch``;
      * a reference ``.pth`` (a released UPSNet state dict, or torchvision
        ImageNet weights for the backbone) loads strictly through the
        converter (``convert/torch_converter.py:load_pretrained``);
      * a JAX (Orbax) snapshot directory is refused by name."""
    if path.endswith(".pth"):
        load_pretrained(path, model, log)
        return
    if os.path.basename(path) == "latest" and not os.path.isdir(path):
        resolved = latest_checkpoint(os.path.dirname(path))
        if resolved is None:
            raise FileNotFoundError(f"pretrained '{path}': no step_* snapshots in "
                                    f"{os.path.dirname(path)}")
        path = resolved
    if os.path.isdir(path):
        raise ValueError(
            f"network.pretrained={path!r} is a directory, a JAX (Orbax) snapshot; write its "
            "parameters as a port checkpoint with upsnet_torch/convert/from_jax.py "
            "(save_jax_params_checkpoint) and name that file")
    saved, expected = read_state_dict(path), model.state_dict()
    reshaped = {k for k in saved.keys() & expected.keys()
                if tuple(saved[k].shape) != tuple(expected[k].shape)}
    if saved.keys() == expected.keys() and not reshaped:
        model.load_state_dict(saved, strict=True)
        log.info("pretrained: loaded %s (exact match)", path)
        return
    off = sorted((saved.keys() ^ expected.keys())
                 | {k for k in reshaped if not is_class_dependent(k)})
    if off:
        raise CheckpointMismatch(f"pretrained {path}: differs from the model beyond the "
                                 f"class-dependent layers: {off[:20]}")
    log.info("pretrained: %s differs from the model in %d class-dependent tensors -> "
             "COCO->Cityscapes head remap", path, len(reshaped))
    model.load_state_dict(remap_coco_state_dict_to_cityscapes(saved, expected), strict=True)


def train(cfg: Config, dataset, logger=None, max_steps: int | None = None, model=None,
          device="cuda", optimizer=None, on_step=None, group: Group | None = None):
    """Train on ``dataset`` as the JAX ``train`` does; returns (model, the
    metrics.jsonl lines as dicts).

    ``model`` defaults to the registry's ``cfg.symbol`` on ``device`` (CUDA
    unless the caller asks for the CPU), with ``network.pretrained`` loaded
    (``load_pretrained_any``); ``optimizer`` to ``make_optimizer``. Under
    ``train.resume`` the newest snapshot of
    ``<output_path>/<symbol>/checkpoints`` is restored into both: weights,
    momentum buffers, the update count the schedule reads, and the
    iteration. As in the JAX loop, the random draws and the loader restart
    from ``cfg.seed`` and position 0: a resumed run replays the stream from
    its start, it does not continue it. ``train.begin_iteration`` moves the
    iteration (snapshot names, the stop test), not the schedule.

    Batches of ``train.batch_size`` come from ``make_loader`` with
    ``train.num_workers`` workers, are encoded by ``train.image_wire`` and
    copied to the device two ahead (``DevicePrefetcher``), and decoded
    there; each image bucket has its anchors and step, over one optimizer.
    The loop stops at iteration ``max_steps or train.max_iteration``. The
    weights after iteration ``it`` are saved to ``checkpoints/step_{it}``
    where ``it % train.snapshot_step == 0`` and at the last iteration.
    ``on_step(it, metrics)``, when given, receives each step's losses and
    its ``lr`` (the schedule's rate) once its interval is read.

    Under a process group (``group``, from ``parallel.mesh.make_group``;
    ``device`` is then the group's) every rank builds the same model from
    the same seed, resumes from the same snapshot, and reads its own stream
    of ``train.batch_size`` batches (``host_id=rank``, ``num_hosts=world``:
    the JAX multi-host stream; the JAX single-host mesh stream, batches of
    ``batch_size * n_dev`` from one loader, is not reproduced). The steps
    are ``parallel/steps.py``'s, whose losses, gradients and metrics are the
    joined batch's. Rank 0 alone writes the log, ``metrics.jsonl`` and the
    snapshots."""
    tc, net = cfg.train, cfg.network
    group = group or Group()
    if logger is None:
        logger = (create_logger(cfg.output_path, cfg.symbol, "train") if group.is_main
                  else logging.getLogger(f"{__name__}.rank{group.rank}"))
    if group.distributed:
        device = group.device
    if model is None:
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"train: device {device} but no CUDA device; pass "
                               "device='cpu' to train on the CPU")
        model = get_model(cfg.symbol, cfg, device=device)
        if net.pretrained:
            load_pretrained_any(net.pretrained, model, logger)
    dev = next(model.parameters()).device
    if optimizer is None:
        optimizer = make_optimizer(cfg, model)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    if group.distributed:
        ddp = ddp_steps.wrap_model(model, cfg, group)
        steps_by_bucket = {
            tuple(b): ddp_steps.make_train_step(ddp, cfg, bucket_anchors(cfg, b, dev),
                                                optimizer, group, generator)
            for b in tc.image_buckets}
    else:
        steps_by_bucket = {
            tuple(b): make_train_step(model, cfg, bucket_anchors(cfg, b, dev), optimizer,
                                      generator)
            for b in tc.image_buckets}

    start_iter = tc.begin_iteration
    ckpt_dir = os.path.join(cfg.output_path, cfg.symbol, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    if tc.resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            start_iter = restore_checkpoint(latest, model, optimizer)
            logger.info("resumed from %s at iter %d (update count %d)", latest, start_iter,
                        update_count(optimizer))
    loader = make_loader(dataset, batch_size=tc.batch_size, num_workers=tc.num_workers,
                         shuffle=True, seed=cfg.seed, host_id=group.rank,
                         num_hosts=group.world)
    logger.info("device %s (%s); image_wire=%s; batch %d a rank, %d ranks, %d loader workers",
                dev, torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host",
                tc.image_wire, tc.batch_size, group.world, tc.num_workers)
    prefetcher = DevicePrefetcher(iter(loader), dev, net.compute_dtype, tc.image_wire)
    log = IntervalLog(model, cfg, logger, group)
    sched = lr_schedule(cfg)
    total_steps = max_steps or tc.max_iteration
    history, lrs = [], []
    it = start_iter

    def flush(last_batch):
        entry, steps = log.flush(it, last_batch["images"])
        history.append(entry)
        if on_step is not None:
            for j, (m, lr) in enumerate(zip(steps, lrs)):
                on_step(it - len(steps) + 1 + j, m | {"lr": lr})
        lrs.clear()

    batch = None
    try:
        while True:
            nxt = log.next_batch(prefetcher)
            if nxt is None or it >= total_steps:
                break
            batch = decode_batch(nxt)
            bucket = tuple(batch["images"].shape[1:3])
            if bucket not in steps_by_bucket:
                raise ValueError(f"a batch of shape {bucket}: not one of train.image_buckets "
                                 f"{sorted(steps_by_bucket)}")
            lrs.append(sched(update_count(optimizer)))
            log.pending.append(steps_by_bucket[bucket](batch))
            it += 1
            if it % tc.display_iter == 0:
                flush(batch)
            if group.is_main and (it % tc.snapshot_step == 0 or it == total_steps):
                logger.info("saved snapshot %s",
                            save_checkpoint(ckpt_dir, it, model, optimizer))
    finally:
        if log.pending and batch is not None:
            flush(batch)
        prefetcher.close()
    return model, history
