"""Profiling helpers (the port of ``upsnet_tpu/utils/profiling.py``).

``trace(logdir)`` records the region under ``torch.profiler`` (the host, and
the card where there is one) and writes a Chrome trace, ``trace.json``, into
``logdir`` (open it in ``chrome://tracing`` or Perfetto); ``timed`` takes the
wall time of a region with the card synchronised on entry and on exit.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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


@contextlib.contextmanager
def timed(name: str, results: dict | None = None):
    """Wall-clock a region, the card synchronised on entry and on exit; the
    seconds go to ``results[name]``, or are printed."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"[timed] {name}: {dt * 1000:.2f} ms")
