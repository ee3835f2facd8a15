"""What a checkpointed trunk (``models/remat.py``) tells the ops inside it.

``recomputing()`` is True while the backward recomputes a checkpointed
trunk; ``sampled`` asks it.

Under ``train.remat_policy: save_dcn`` one ``SavedSamples`` store belongs to
each checkpointed call and is in scope in its first forward and in its
recompute. The three sampling Functions (``DeformSampleTaps``,
``DeformSampleTiled``, ``DeformSampleShift``) pass their kernel launch
through ``sampled``: in the first forward it launches and keeps the output;
in the recompute it hands the kept output back by its position among the
trunk's sampling calls, lets go of it, and launches nothing. Positions, and
not a queue, because the non-reentrant checkpoint may stop a recompute
early. The recompute empties the store when it ends, and the store lives
only as long as the checkpoint's graph refers to it, so a step whose graph
is dropped without a backward leaves nothing behind. Every other op of the
trunk runs as it would without remat: no dispatch mode is involved.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

_state = threading.local()


def recomputing() -> bool:
    """True while a checkpointed trunk is being recomputed in the backward."""
    return getattr(_state, "recompute", False)


class SavedSamples:
    """The sampled outputs of one checkpointed call, in call order."""

    def __init__(self):
        self.outs: list[torch.Tensor | None] = []  # None: handed back
        self.next = 0  # the position the recompute reads next


class Scope:
    """Context of a checkpointed call's first forward (``recompute`` False)
    or of its recompute, with ``store`` (None: nothing kept) in scope.
    Reusable: a graph kept with ``retain_graph`` recomputes again."""

    def __init__(self, store: SavedSamples | None, recompute: bool):
        self.store, self.recompute = store, recompute

    def __enter__(self):
        self.prev = recomputing(), getattr(_state, "store", None)
        _state.recompute, _state.store = self.recompute, self.store
        if self.store is not None:
            self.store.next = 0

    def __exit__(self, *exc):
        _state.recompute, _state.store = self.prev
        if self.recompute and self.store is not None:
            self.store.outs.clear()


def sampled(launch: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``launch()``, a sampling kernel's call, kept or handed back as the
    store in scope says; outside a ``save_dcn`` checkpoint just ``launch()``.
    The store holds an output no longer than the recompute needs it (the
    backward needs the sampled output itself nowhere: the bias add after it
    saves nothing). An output handed back already (a second recompute of a
    retained graph) is launched again."""
    store = getattr(_state, "store", None)
    if store is None:
        return launch()
    if recomputing():
        i = store.next
        store.next += 1
        out = store.outs[i] if i < len(store.outs) else None
        if out is None:
            return launch()
        store.outs[i] = None
        return out
    out = launch()
    store.outs.append(out.detach())
    return out
