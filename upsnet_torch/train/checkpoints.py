"""Checkpoint save/restore in the reference's format.

Reference behavior (SURVEY.md §5.4): ``torch.save({state_dict, optimizer,
iteration})`` at snapshot boundaries under ``output/<cfg>/...``; resume
reloads the latest. The JAX package writes the same triple with Orbax
(``upsnet_tpu/train/checkpoints.py``); here it is one ``torch.save`` file,
``<ckpt_dir>/step_{step:08d}``, holding:

  * ``state_dict``: the model's ``state_dict()``, parameters and the
    frozen-BN buffers under the module tree's names (the flax tree's, see
    ``convert/from_jax.py``);
  * ``optimizer``: ``optimizer.state_dict()``, or None when none was saved;
  * ``iteration``: the step.

``restore_checkpoint`` checks the saved names and shapes against the model
first and raises ``CheckpointMismatch`` with the named differences, as the
JAX ``restore_checkpoint`` does against its template.
"""

from __future__ import annotations

import os

import torch
from torch import nn

STEP_PREFIX = "step_"


def write_checkpoint(ckpt_dir: str, step: int, state_dict, optimizer_state=None) -> str:
    """Write ``{state_dict, optimizer, iteration}`` to
    ``<ckpt_dir>/step_{step:08d}`` (through a temporary file, so that a
    reader never sees half a snapshot). Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"{STEP_PREFIX}{step:08d}")
    tmp = path + ".tmp"
    torch.save({"state_dict": dict(state_dict), "optimizer": optimizer_state,
                "iteration": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, step: int, model: nn.Module,
                    optimizer: torch.optim.Optimizer | None = None) -> str:
    """Snapshot ``model`` (and ``optimizer``'s state, when given) at ``step``."""
    return write_checkpoint(ckpt_dir, step, model.state_dict(),
                            None if optimizer is None else optimizer.state_dict())


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The path of the highest ``step_*`` snapshot in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith(STEP_PREFIX) and not d.endswith(".tmp"))
    return os.path.join(os.path.abspath(ckpt_dir), steps[-1]) if steps else None


def read_state_dict(path: str) -> dict:
    """The model weights of the snapshot at ``path``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["state_dict"]


class CheckpointMismatch(ValueError):
    """Raised at restore time when the snapshot does not match the model (or
    the optimizer) it is restored into, with the named differences."""


def _diff_against_model(saved: dict, expected: dict) -> list[str]:
    """Named differences of the saved state_dict against the model's:
    missing, unexpected and shape-changed keys; empty when they agree."""
    problems = [f"missing from checkpoint: {k} {tuple(expected[k].shape)}"
                for k in sorted(expected.keys() - saved.keys())]
    problems += [f"unexpected in checkpoint: {k} {tuple(saved[k].shape)}"
                 for k in sorted(saved.keys() - expected.keys())]
    problems += [f"shape mismatch at {k}: checkpoint {tuple(saved[k].shape)} vs model "
                 f"{tuple(expected[k].shape)}"
                 for k in sorted(saved.keys() & expected.keys())
                 if tuple(saved[k].shape) != tuple(expected[k].shape)]
    return problems


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: torch.optim.Optimizer | None = None,
                       partial: bool = False) -> int:
    """Load the snapshot at ``path`` into ``model`` (and ``optimizer``) in
    place; returns its iteration. Tensors are read onto the CPU
    (``map_location``) and copied into the model's and the optimizer's own
    devices, so a snapshot written on the card restores on the CPU and back.

    ``partial=False`` restores the whole snapshot: the optimizer must be
    given and its state must be in the snapshot. ``partial=True`` restores
    only what is given (e.g. the weights alone, for inference) and ignores
    the rest. Either way the model's keys and shapes must equal the
    snapshot's, or this raises ``CheckpointMismatch`` naming the keys."""
    path = os.path.abspath(path)
    if optimizer is None and not partial:
        raise ValueError("restore_checkpoint: a full restore needs the optimizer; pass "
                         "partial=True to restore the model alone")
    state = torch.load(path, map_location="cpu", weights_only=True)
    problems = _diff_against_model(state["state_dict"], model.state_dict())
    if optimizer is not None and state["optimizer"] is None:
        problems.append("missing from checkpoint: optimizer")
    if problems:
        head = problems[:20]
        more = len(problems) - len(head)
        raise CheckpointMismatch(
            f"checkpoint {path} does not match the model ({len(problems)} differences):\n  "
            + "\n  ".join(head) + (f"\n  ... and {more} more" if more else ""))
    model.load_state_dict(state["state_dict"], strict=True)
    if optimizer is not None:
        try:
            optimizer.load_state_dict(state["optimizer"])
        except ValueError as e:  # parameter groups of other sizes
            raise CheckpointMismatch(f"checkpoint {path}: optimizer state: {e}") from e
    return int(state["iteration"])
