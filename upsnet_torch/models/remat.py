"""Activation checkpointing of the dense trunk: ``train.remat`` and
``train.remat_policy``.

Port of the ``jax.checkpoint`` around ``extract`` in
``upsnet_tpu/models/upsnet.py:forward_train``, with its mapping kept:

  * ``remat: False`` keeps every activation of the trunk for the backward;
  * ``remat: True`` with ``remat_policy: save_dcn`` keeps only the deformable
    convs' sampled outputs (JAX: ``save_only_these_names("dcn_out")``) and
    recomputes the rest of the trunk in the backward; the sampling kernels
    (the all-tap K2, K6 and K8a) run once a step, as without remat, since
    their own backwards need the projections and the coordinates, which the
    recompute rebuilds, and not their outputs;
  * ``remat: True`` with any other policy ('' is the documented one)
    recomputes everything, the sampling kernels included (twice a step).

The checkpoint is ``torch.utils.checkpoint``'s non-reentrant form. The
reentrant form runs the first forward without autograd, so each
``DeformConv`` would take its inference ``impl`` (K1) there, and the
parameters would get no gradient through it. ``save_dcn`` is selective
checkpointing: the sampling forwards are dispatcher ops
(``deform_sample.deform_sample_taps_op``, ``deform_sample_tiled_taps_op``,
``deform_shift.shift_fwd_op``), their outputs are cached in the forward and
handed back in the recompute instead of running the op again. Every other op
of the trunk is recomputed. Recomputed values are the first forward's bits
where the ops are deterministic, so the three settings give the same step.

Side effects of the trunk that must not repeat in the recompute ask
``recomputing()``: ``DeformConv`` records its offsets' extremes only in the
first forward.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from upsnet_torch.ops import deform_sample, deform_shift  # noqa: F401  (they define the ops)

_state = threading.local()

# the ops whose outputs ``save_dcn`` keeps: the sampling forwards
SAVED_OPS = frozenset((torch.ops.upsnet.deform_sample_taps.default,
                       torch.ops.upsnet.deform_sample_tiled_taps.default,
                       torch.ops.upsnet.shift_fwd.default))


def recomputing() -> bool:
    """True while a checkpointed trunk is being recomputed in the backward."""
    return getattr(_state, "recompute", False)


@contextlib.contextmanager
def _recompute(inner=contextlib.nullcontext()):
    prev = recomputing()
    _state.recompute = True
    try:
        with inner:
            yield
    finally:
        _state.recompute = prev


def _save_dcn_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dcn_contexts():
    forward, recompute = create_selective_checkpoint_contexts(_save_dcn_policy)
    return forward, _recompute(recompute)


def _full_contexts():
    return contextlib.nullcontext(), _recompute()


def run_checkpointed(fn, x: torch.Tensor, remat: bool, policy: str):
    """``fn(x)`` under ``train.remat`` / ``train.remat_policy``, as the JAX
    ``forward_train`` wraps ``extract``. Without autograd recording there is
    nothing to keep, and ``fn`` runs as it is."""
    if not (remat and torch.is_grad_enabled()):
        return fn(x)
    contexts = _save_dcn_contexts if policy == "save_dcn" else _full_contexts
    return checkpoint(fn, x, use_reentrant=False, context_fn=contexts)
