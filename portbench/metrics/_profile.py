"""Reading a ``torch.profiler`` trace of a steady stretch of the window.

The arithmetic of the program's ``chip_smoke.py:phase_profile``, copied so
that a later change to the program cannot move it: per ``<prefix>`` stage
the host ms of its range, the device span of the kernels it launched and
their busy ms; a stage that launches from another thread (the backward pass
runs on autograd's) gets the device time between its neighbours' device
ranges instead; the device's busy time as the union of its kernels'
intervals, and the idle share of the same stretch's untraced wall time; the
largest device ops by name, and the longest idle gaps, each named by the
stage and the host op that ran while the device waited.
"""

from __future__ import annotations

from torch.autograd import DeviceType

DCN_RANGE = "portbench.dcn"


def _union_us(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def summarize(events, prefix: str, untraced_s: float, other_thread=()) -> dict:
    """``events``: ``prof.events()`` of the recorded stretch. ``untraced_s``:
    the host clock over the same stretch run untraced, ending in a
    synchronise; the idle share divides by it, since the profiler's cost per
    op on the host would count as idle time."""
    annotations = {e.name for e in events
                   if e.device_type != DeviceType.CUDA and e.is_user_annotation}
    host, host_ranges, spans, kernels, dcn_spans = {}, [], [], [], []
    for e in events:
        on_device = e.device_type == DeviceType.CUDA
        if e.name in annotations or (on_device and e.is_user_annotation):
            if e.name == DCN_RANGE:
                if on_device:
                    dcn_spans.append((e.time_range.start, e.time_range.end))
            elif e.name.startswith(prefix):
                if not on_device:
                    host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                    host_ranges.append((e.time_range.start, e.time_range.end, e.name))
                elif e.name not in other_thread:
                    spans.append((e.time_range.start, e.time_range.end, e.name))
        elif on_device:
            kernels.append(e)
    spans += _other_thread_spans(host_ranges, spans, kernels, other_thread)
    busy = dict.fromkeys(host, 0.0)
    per_name: dict[str, float] = {}
    dcn_ms = 0.0
    for k in kernels:
        ms = k.time_range.elapsed_us() / 1e3
        per_name[k.name] = per_name.get(k.name, 0.0) + ms
        t = k.time_range.start
        for start, end, name in spans:
            if start <= t <= end:
                busy[name] = busy.get(name, 0.0) + ms
                break
        if any(s <= t <= e for s, e in dcn_spans):
            dcn_ms += ms
    intervals = [(k.time_range.start, k.time_range.end) for k in kernels]
    busy_ms = _union_us(intervals) / 1e3
    clock_ms = untraced_s * 1e3
    return {
        "untraced_ms": clock_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / clock_ms,
        "n_ops": len(kernels), "stage_host_ms": host, "stage_busy_ms": busy,
        "dcn_device_ms": dcn_ms, "dcn_calls": len(dcn_spans),
        "top_ops": sorted(per_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": _idle_gaps(events, intervals, host_ranges),
    }


def _other_thread_spans(host_ranges, spans, kernels, other_thread) -> list:
    """Device spans of the stages in ``other_thread``, one per occurrence:
    from the end of the device span of the stage that ran on the host just
    before it to the start of that of the stage just after it (the j-th host
    range of a name owns the j-th device range of that name)."""
    device = {}
    for s_, e_, n in sorted(spans):
        device.setdefault(n, []).append((s_, e_))
    ranks, seen = {}, {}
    ordered = sorted(host_ranges)
    for r in ordered:
        ranks[r] = seen.get(r[2], 0)
        seen[r[2]] = ranks[r] + 1

    def device_span(r):
        lst = device.get(r[2], [])
        return lst[ranks[r]] if ranks[r] < len(lst) else None

    first = min((k.time_range.start for k in kernels), default=0)
    last = max((k.time_range.end for k in kernels), default=0)
    out = []
    for i, r in enumerate(ordered):
        if r[2] not in other_thread:
            continue
        before = [device_span(p) for p in ordered[:i] if p[2] not in other_thread]
        after = [device_span(p) for p in ordered[i + 1:] if p[2] not in other_thread]
        before = [d for d in before if d]
        after = [d for d in after if d]
        out.append((before[-1][1] if before else first, after[0][0] if after else last, r[2]))
    return out


def _idle_gaps(events, intervals, host_ranges, n: int = 10) -> list:
    """The ``n`` longest device gaps, each as ["<stage>: <host op>", s]."""
    gaps, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    host_ops = [e for e in events if e.device_type != DeviceType.CUDA and not e.is_user_annotation
                and e.cpu_parent is not None and e.cpu_parent.is_user_annotation]
    out = []
    for g0, g1 in gaps:
        stage = next((n_ for s_, e_, n_ in host_ranges if s_ <= g0 <= e_), "no stage")
        op = next((e.name for e in host_ops if e.time_range.start <= g0 <= e.time_range.end), "")
        out.append([f"{stage}: {op}" if op else stage, (g1 - g0) / 1e6])
    return out


def breakdown(summary: dict) -> dict:
    return {"device_ops": [[n, ms / 1e3] for n, ms in summary["top_ops"]],
            "idle_gaps": summary["idle_gaps"]}
