"""The program's blocking reads in a profiled stretch: the host ``sync.<site>``
ranges that ``upsnet_torch/utils/profiling.py:host_sync`` opens around each
read from the card while a profiler records (a flag, a copy to the host, a
constant copied from pageable host memory). A program without them leaves
the stretch with no such range, and the readers then read nothing.

The recorded phase slows the host (the profiler's cost per op), so less work
is queued ahead of each read than untraced: the wait inside the ranges reads
low against an untraced run, and the count does not move.
"""

from __future__ import annotations

from torch.autograd import DeviceType

SYNC_PREFIX = "sync."


def sync_ranges(events) -> list:
    """The host ``sync.*`` ranges of ``events`` (``prof.events()``)."""
    return [e for e in events if e.device_type != DeviceType.CUDA and e.is_user_annotation
            and e.name.startswith(SYNC_PREFIX)]


def per_unit(ctx: dict, unit: str, wait: bool):
    """The ranges' count (``wait`` False) or host ms inside them (True) over
    the stretch's ``unit`` (``requests`` or ``steps``); None where the
    stretch holds no range."""
    t = ctx.get("traced")
    if not t or not t.get(unit):
        return None
    ranges = sync_ranges(t["events"])
    if not ranges:
        return None
    total = sum(e.time_range.elapsed_us() for e in ranges) / 1e3 if wait else len(ranges)
    return total / t[unit]
