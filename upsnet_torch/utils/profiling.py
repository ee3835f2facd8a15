"""Profiling helpers (the port of ``upsnet_tpu/utils/profiling.py``).

``trace(logdir)`` records the region under ``torch.profiler`` (the host, and
the card where there is one) and writes a Chrome trace, ``trace.json``, into
``logdir`` (open it in ``chrome://tracing`` or Perfetto).

``host_sync(site)`` marks one blocking read from the card: a value the host
waits for (a flag, a copy to the host, a constant copied from pageable host
memory, which PyTorch follows with a stream synchronise). Every entry adds 1
to ``site``'s count in a per-process table (``read_syncs``,
``reset_syncs``); a read that copies a tensor to the host also adds its
bytes to ``site``'s total (``read_bytes``). While a ``torch.profiler``
records, the read also runs inside a ``sync.<site>`` range, on the
profiler's clock with the kernels and the ``predict.<stage>`` /
``train.<stage>`` / ``tta.<stage>`` ranges. With no profiler recording it
costs one flag check and one or two integer adds.

``count_canvas(bucket, content)`` adds one forward's input canvas to a
per-process tally of pixels (``read_canvas``): the canvas ``bh·bw``, the
content that lies inside it ``min(rh, bh)·min(rw, bw)``, and the resized
content ``rh·rw`` (more than what lies inside where the content outgrows
every bucket and is cropped). Host integers only: no read, no sync.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

SYNC_PREFIX = "sync."

_syncs: dict[str, int] = {}
_bytes: dict[str, int] = {}
_pixels = {"canvas": 0, "inside": 0, "resized": 0}


class host_sync:
    """Context manager around one blocking read at ``site``: counts it, adds
    ``nbytes`` (the bytes it copies to the host, if any) to the site's total,
    and records it as a ``sync.<site>`` range while a profiler records."""

    __slots__ = ("site", "nbytes", "_range")

    def __init__(self, site: str, nbytes: int = 0):
        self.site = site
        self.nbytes = nbytes
        self._range = None

    def __enter__(self):
        _syncs[self.site] = _syncs.get(self.site, 0) + 1
        if self.nbytes:
            _bytes[self.site] = _bytes.get(self.site, 0) + self.nbytes
        if _profiler_enabled():
            self._range = record_function(SYNC_PREFIX + self.site)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)


def read_syncs() -> dict[str, int]:
    """The blocking reads counted per site since the last ``reset_syncs``."""
    return dict(_syncs)


def read_bytes() -> dict[str, int]:
    """The bytes copied to the host per site since the last ``reset_syncs``."""
    return dict(_bytes)


def count_canvas(bucket, content) -> None:
    """Tally one forward's canvas ``bucket`` (bh, bw) holding ``content``
    (rh, rw), the image resized before any crop to the canvas."""
    (bh, bw), (rh, rw) = bucket, content
    _pixels["canvas"] += bh * bw
    _pixels["inside"] += min(rh, bh) * min(rw, bw)
    _pixels["resized"] += rh * rw


def read_canvas() -> dict[str, int]:
    """The pixels tallied by ``count_canvas`` since the last
    ``reset_syncs``: ``canvas``, ``inside`` and ``resized``."""
    return dict(_pixels)


def reset_syncs() -> None:
    _syncs.clear()
    _bytes.clear()
    _pixels.update(dict.fromkeys(_pixels, 0))


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler trace of the region when ``logdir`` is set; no-op
    otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
