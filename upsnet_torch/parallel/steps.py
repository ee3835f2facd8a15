"""The data-parallel train step, the port's counterpart of the sharded
``make_train_step`` of ``upsnet_tpu/parallel/steps.py``.

The JAX step runs ``forward_train`` on the joined batch of every device's
rows and XLA inserts the gradient psum; its losses, gradients and metrics
are those of the joined batch. Here each rank runs its own rows under
``DistributedDataParallel`` and three things make the result the joined
batch's:

  * **normalisers**: every loss term that divides by a count over the batch
    (``models.upsnet.COUNT_KEYS``) divides by the joined batch's, all-reduced
    without grad before dividing, so each rank's terms are its share of the
    joined batch's and their sum over the ranks is the joined loss; DDP's
    gradient average is replaced by a sum (``_allreduce_sum``), which gives
    the joined batch's gradient;
  * **random draws**: every rank draws the joined batch's noise
    (``draw_noise``) from the same-seeded generator and keeps its own rows,
    so the draws do not repeat across ranks and the step equals the
    single-process step on the joined batch drawn from that generator;
  * **metrics**: the loss dict is all-reduced, so every rank logs the joined
    batch's numbers, as JAX's replicated metrics are.

Ranks hold equal batches (``train.batch_size`` each); they may hold
different buckets at one step, which DDP allows. Such a step equals no
single-process step, and each rank then draws the joined noise at its own
bucket's anchor count.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.profiler import record_function

from upsnet_torch.config.defaults import Config
from upsnet_torch.models.upsnet import draw_noise, forward_train
from upsnet_torch.parallel.mesh import Group
from upsnet_torch.train.optimizer import sgd_update


class _TrainForward(nn.Module):
    """``forward_train`` as a module's forward, so that DDP sees the call."""

    def __init__(self, model: nn.Module, cfg: Config):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, batch, anchors, noise, joined_counts):
        return forward_train(self.model, self.cfg, anchors, batch, noise,
                             joined_counts=joined_counts)


def _allreduce_sum(state, bucket):
    """DDP communication hook: the gradients' sum over the ranks, not their
    mean (each rank's loss is already its share of the joined batch's)."""
    fut = dist.all_reduce(bucket.buffer(), async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def wrap_model(model: nn.Module, cfg: Config, group: Group) -> DistributedDataParallel:
    """The DDP wrapper of ``model``'s train forward over ``group``: one for
    the whole run, shared by every bucket's step. Buffers (the FrozenBN
    affines) are not broadcast at each forward: they never change."""
    dev = next(model.parameters()).device
    ddp = DistributedDataParallel(
        _TrainForward(model, cfg), device_ids=[dev] if dev.type == "cuda" else None,
        broadcast_buffers=False)
    ddp.register_comm_hook(None, _allreduce_sum)
    return ddp


def make_train_step(ddp: DistributedDataParallel, cfg: Config, anchors,
                    optimizer: torch.optim.Optimizer, group: Group,
                    generator: torch.Generator | None = None):
    """Returns ``step(batch, noise=None) -> metrics`` for this rank's rows
    ``batch`` of the joined batch: forward under ``ddp``, backward with the
    gradients summed over ``group``, the clip and SGD update of
    ``train/step.py``. ``noise`` is the joined batch's (``forward_train``'s
    keys, ``world * B`` rows, rank-major); without it every rank draws the
    joined batch's from ``generator`` (``draw_noise``). ``metrics`` are the
    joined batch's 7 terms and ``total``, detached, on every rank."""
    n_anchors = sum(int(a.shape[0]) for a in anchors)

    def joined_counts(counts):
        return group.all_reduce_sum(counts.clone())

    def step(batch, noise=None):
        b = batch["images"].shape[0]
        dev = batch["images"].device
        if noise is None:
            noise = draw_noise(cfg, b * group.world, n_anchors, generator, dev)
        mine = {k: v[group.rank * b:(group.rank + 1) * b] for k, v in noise.items()}
        optimizer.zero_grad(set_to_none=True)
        total, losses = ddp(batch, anchors, mine, joined_counts)
        with record_function("train.backward"):
            total.backward()
        with record_function("train.update"):
            sgd_update(optimizer, cfg)
        keys = (*losses, "total")
        values = torch.stack([*losses.values(), total]).detach().float()
        values = group.all_reduce_sum(values)
        return dict(zip(keys, values.unbind()))

    return step
