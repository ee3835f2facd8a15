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

The checkpoint is ``torch.utils.checkpoint``'s non-reentrant form under
both policies. The reentrant form runs the first forward without autograd,
so each ``DeformConv`` would take its inference ``impl`` (K1) there, and the
parameters would get no gradient through it. ``save_dcn`` differs from full
remat only in a ``SavedSamples`` store (``ops/recompute.py``) in scope in the
first forward and the recompute: the sampling Functions keep their outputs
there and hand them back in the recompute instead of launching again. No
dispatch mode runs, so every other op costs what it costs under full remat.
Recomputed values are the first forward's bits where the ops are
deterministic, so the three settings give the same step.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from upsnet_torch.ops.recompute import SavedSamples, Scope


def _save_dcn_contexts():
    store = SavedSamples()
    return Scope(store, recompute=False), Scope(store, recompute=True)


def _full_contexts():
    return contextlib.nullcontext(), Scope(None, recompute=True)


def run_checkpointed(fn, x: torch.Tensor, remat: bool, policy: str):
    """``fn(x)`` under ``train.remat`` / ``train.remat_policy``, as the JAX
    ``forward_train`` wraps ``extract``. Without autograd recording there is
    nothing to keep, and ``fn`` runs as it is."""
    if not (remat and torch.is_grad_enabled()):
        return fn(x)
    contexts = _save_dcn_contexts if policy == "save_dcn" else _full_contexts
    return checkpoint(fn, x, use_reentrant=False, context_fn=contexts)
