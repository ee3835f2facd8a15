"""Where the program blocks on the card, in one benchmark cell.

    python3 portbench/sync_audit.py --workload <cell> --seed <n> [--units 3] [--repeats 3]

from the root of a checkout, on a CUDA card. After the cell's set-up:

1. ``--units`` requests (or steps) one at a time under
   ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising operation
   the card reports, by the line that made it and whether it ran inside the
   program's ``host_sync`` (``upsnet_torch/utils/profiling.py``), beside that
   unit's ``read_syncs()`` delta;
2. the cell's traced stretch as ``--trace 1`` runs it: the card's idle gaps
   split by what the host was doing as each opened (inside a ``sync.<site>``
   range, or queueing work), the host ms inside the ranges, and the
   blocking-read readers' values;
3. the same stretch ``--repeats`` times with the ranges and without them, in
   turns: the recorded phase's wall seconds, what the ranges cost while the
   profiler records.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import linecache
import pathlib
import sys
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the text of the warning that torch.cuda.set_sync_debug_mode("warn") gives
SYNC_WARNING = "called a synchronizing CUDA operation"


def _gaps(events):
    """(kernel intervals' idle gaps [(start, end)], busy us), over the device
    kernels as ``metrics/_profile.py`` takes them."""
    from torch.autograd import DeviceType

    from portbench.metrics._profile import _union_us

    annotations = {e.name for e in events
                   if e.device_type != DeviceType.CUDA and e.is_user_annotation}
    intervals = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                       and e.name not in annotations)
    gaps, end = [], None
    for s, e in intervals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps, _union_us(intervals)


def idle_split(traced: dict) -> dict:
    """The traced stretch's idle gaps by what the host did as each opened."""
    from portbench.metrics._syncs import sync_ranges

    events = traced["events"]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in sync_ranges(events))
    gaps, busy_us = _gaps(events)
    by = {}
    for g0, g1 in gaps:
        site = next((n for s, e, n in ranges if s <= g0 <= e), "dispatch")
        ms, n = by.get(site, (0.0, 0))
        by[site] = (ms + (g1 - g0) / 1e3, n + 1)
    idle_ms = sum(ms for ms, _ in by.values())
    in_sync = sum(ms for k, (ms, _) in by.items() if k != "dispatch")
    return {"busy_ms": busy_us / 1e3, "gap_ms": idle_ms, "wall_s": traced["wall_s"],
            "untraced_s": traced["untraced_s"],
            "sync_share_of_gaps": in_sync / idle_ms if idle_ms else None,
            "gaps_by_opening": {k: {"ms": ms, "gaps": n} for k, (ms, n) in sorted(by.items())},
            "sync_host_ms": sum(e - s for s, e, _ in ranges) / 1e3, "sync_ranges": len(ranges)}


def _where(filename: str, lineno: int) -> str:
    """``file:line`` of a warning, relative to the checkout; for a line
    outside it, the source line and the stack's frames inside it too."""
    path = pathlib.Path(filename).resolve()
    if path.is_relative_to(ROOT):
        return f"{path.relative_to(ROOT)}:{lineno}"
    frames = [f"{pathlib.Path(f.filename).resolve().relative_to(ROOT)}:{f.lineno} {f.name}"
              for f in traceback.extract_stack()
              if pathlib.Path(f.filename).resolve().is_relative_to(ROOT)]
    source = linecache.getline(filename, lineno).strip()
    return f"{filename}:{lineno} ({source}) from {' < '.join(reversed(frames[-6:]))}"


def audit_units(unit, n: int) -> list:
    """``unit(k)`` for k < n, each under the sync debug mode."""
    import torch

    from upsnet_torch.utils import profiling

    depth = [0]
    enter, leave = profiling.host_sync.__enter__, profiling.host_sync.__exit__

    def _enter(self):
        depth[0] += 1
        return enter(self)

    def _leave(self, *exc):
        depth[0] -= 1
        return leave(self, *exc)

    out = []
    profiling.host_sync.__enter__, profiling.host_sync.__exit__ = _enter, _leave
    try:
        for k in range(n):
            seen, other = [], []

            def record(message, category, filename, lineno, file=None, line=None):
                if SYNC_WARNING in str(message):
                    seen.append((_where(filename, lineno), depth[0] > 0))
                else:
                    other.append(f"{category.__name__} at {_where(filename, lineno)}: "
                                 f"{str(message)[:300]}")

            torch.cuda.synchronize()
            profiling.reset_syncs()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    unit(k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            where = {}
            for at, inside in seen:
                key = at if inside else "OUTSIDE " + at
                where[key] = where.get(key, 0) + 1
            counted = profiling.read_syncs()
            out.append({"warnings": len(seen), "counted": sum(counted.values()),
                        "outside": sum(1 for _, inside in seen if not inside),
                        "sites": counted, "lines": where, "other_warnings": other})
    finally:
        profiling.host_sync.__enter__, profiling.host_sync.__exit__ = enter, leave
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=3)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import metrics as M
    from portbench import run

    run.set_cache_dirs()
    import torch

    from portbench.traffic.generator import request_order
    from upsnet_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    manifest, cell, conf, mix = run.cell_files(args.workload)
    driver = run.load_driver(mix["kind"])
    torch.set_num_threads(4)
    runner = driver.Cell(conf, mix, args.seed, "cuda")
    predict = mix["kind"] == "predict"
    if predict:
        order = request_order(mix, args.seed, 1 << 10)
        ids = order[:int(mix["trace_requests"])]
        unit = lambda k: runner.request(int(order[k]))  # noqa: E731
        stretch = lambda: runner._traced(ids)  # noqa: E731
    else:
        i0 = runner.i + args.units

        def unit(k):
            runner.step()

        def stretch():
            runner.i = i0
            return runner._traced(int(mix["trace_steps"]))

    units = audit_units(unit, args.units)
    traced = stretch()
    ctx = {"traced": traced}
    names = [m["name"] for m in manifest["per_layer"]
             if m["name"].startswith(("host_syncs.", "sync_wait_ms."))
             and args.workload in m.get("workloads", [args.workload])]
    result = {"workload": args.workload, "seed": args.seed, "card": run.power_limit(),
              "torch": torch.__version__, "units": units,
              "all_inside": all(u["outside"] == 0 and u["warnings"] == u["counted"]
                                for u in units),
              "stretch": idle_split(traced), "readers": M.read_all(names, ctx)}
    walls = {"with": [], "without": []}
    for _ in range(args.repeats):
        walls["with"].append(stretch()["wall_s"])
        enabled = profiling._profiler_enabled
        profiling._profiler_enabled = lambda: False
        try:
            walls["without"].append(stretch()["wall_s"])
        finally:
            profiling._profiler_enabled = enabled
    result["recorded_wall_s"] = walls
    runner.release()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
