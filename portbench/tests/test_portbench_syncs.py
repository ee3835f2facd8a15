"""The blocking-read readers (``metrics/host_syncs.*``, ``metrics/sync_wait_ms.*``)
on CPU-profiled tiny stretches, and ``_profile.summarize`` unmoved by the
program's ``sync.*`` ranges.

  * on a tiny predict and a tiny train stretch, the readers return the
    ranges' count per request or step, which is the program's own count
    (``read_syncs``) over the stretch's three runs, and a positive wait;
  * on a stretch the program recorded without the ranges (as a program
    without ``host_sync`` leaves it), and without a traced stretch, they
    return None;
  * ``summarize`` gives the same dict on one stretch with the ranges and
    with them taken out (their children handed to their parents), also
    with device kernels laid so that idle gaps open inside every range.
"""

import dataclasses

import pytest
from torch.autograd import DeviceType

from portbench import metrics as M
from portbench.drivers import predict as D
from portbench.drivers import train as T
from portbench.metrics import _profile
from portbench.metrics._syncs import sync_ranges
from portbench.tests.tiny import tiny_config, tiny_mix, tiny_train_mix
from portbench.traffic.generator import request_order

SEED = 2 ** 31 + 515
READERS = {"predict": ("host_syncs.predict", "sync_wait_ms.predict"),
           "train": ("host_syncs.train", "sync_wait_ms.train")}


def _stretches(kind: str, monkeypatch) -> dict:
    """The traced stretch of a tiny ``kind`` cell with the ranges, the
    program's counts over its three runs, and the same stretch recorded
    with the ranges off."""
    from upsnet_torch.utils import profiling

    conf = tiny_config()
    if kind == "predict":
        mix = tiny_mix()
        cell = D.Cell(conf, mix, SEED, "cpu")
        ids = request_order(mix, SEED, 8)[:2]
        trace = lambda: cell._traced(ids)  # noqa: E731
    else:
        cell = T.Cell(conf, tiny_train_mix(), SEED, "cpu")
        i0 = cell.i

        def trace():
            cell.i = i0
            return cell._traced(1)
    profiling.reset_syncs()
    traced = trace()
    counts = profiling.read_syncs()
    with monkeypatch.context() as m:
        m.setattr(profiling, "_profiler_enabled", lambda: False)
        bare = trace()
    cell.release()
    return {"traced": traced, "counts": counts, "bare": bare}


@pytest.fixture(scope="module", params=["predict", "train"])
def stretch(request):
    with pytest.MonkeyPatch.context() as mp:
        yield request.param, _stretches(request.param, mp)


def test_readers_count_the_programs_syncs(stretch):
    kind, s = stretch
    count_name, wait_name = READERS[kind]
    t = s["traced"]
    n = t["requests"] if kind == "predict" else t["steps"]
    count = M.load(count_name).read({"traced": t})
    wait = M.load(wait_name).read({"traced": t})
    total = sum(s["counts"].values())
    assert count > 0 and count * n * 3 == total, (count, n, s["counts"])
    assert wait > 0
    by_site = {}
    for e in sync_ranges(t["events"]):
        by_site[e.name] = by_site.get(e.name, 0) + 1
    assert {k: 3 * v for k, v in by_site.items()} == {
        f"sync.{k}": v for k, v in s["counts"].items()}
    assert M.read_all(READERS[kind], {"traced": t}).keys() == set(READERS[kind])


def test_readers_read_nothing_without_ranges(stretch):
    kind, s = stretch
    assert not sync_ranges(s["bare"]["events"])
    # the card's side of a range (its kernels' span) is no host range
    device_side = _Event(name="sync.to_host", device_type=DeviceType.CUDA,
                         is_user_annotation=True, time_range=_Range(0.0, 5.0), cpu_parent=None)
    bare = dict(s["bare"], events=list(s["bare"]["events"]) + [device_side])
    for name in READERS[kind]:
        reader = M.load(name)
        assert reader.read({"traced": bare}) is None
        assert reader.read({"traced": None}) is None
        assert reader.read({}) is None


class _Event:
    """A profiler event seen through another parent, or made up."""

    def __init__(self, base=None, parent=None, **fields):
        self._base, self._fields = base, dict(fields)
        if base is not None:
            self._fields["cpu_parent"] = parent

    def __getattr__(self, name):
        if name in self._fields:
            return self._fields[name]
        return getattr(self._base, name)


@dataclasses.dataclass
class _Range:
    start: float
    end: float

    def elapsed_us(self):
        return self.end - self.start


def _kernel(start, end, name="k"):
    return _Event(name=name, device_type=DeviceType.CUDA, is_user_annotation=False,
                  time_range=_Range(start, end), cpu_parent=None)


def _without_ranges(events) -> list:
    """``events`` with the host ``sync.*`` ranges taken out and each of their
    children given the range's parent."""
    gone = {id(e) for e in sync_ranges(events)}

    def parent(e):
        p = e.cpu_parent
        while p is not None and id(p) in gone:
            p = p.cpu_parent
        return p

    return [_Event(e, parent(e)) for e in events if id(e) not in gone]


def _gapped_kernels(events) -> list:
    """Device kernels that cover the stretch but for gaps of distinct
    lengths, each opening in the middle of one host op inside a ``sync.*``
    range (and of one op outside them): every gap is named by the host op
    that was running as it opened."""
    ranges = sync_ranges(events)
    inside = [c for r in ranges for c in r.cpu_children][:8]
    outside = [e for e in events if e.device_type != DeviceType.CUDA
               and not e.is_user_annotation and e.cpu_parent is not None
               and e.cpu_parent.is_user_annotation
               and not e.cpu_parent.name.startswith("sync.")][:2]
    opens = sorted((e.time_range.start + e.time_range.end) / 2 for e in inside + outside)
    t0 = min(e.time_range.start for e in events if e.device_type != DeviceType.CUDA)
    kernels, at = [], t0
    for i, g0 in enumerate(opens):
        if g0 > at:
            kernels.append(_kernel(at, g0))
        at = max(at, g0) + 0.01 * (i + 1)
    kernels.append(_kernel(at, at + 1.0))
    return kernels


def test_summarize_is_the_same_with_and_without_the_ranges(stretch):
    kind, s = stretch
    t = s["traced"]
    prefix = D.PREFIX if kind == "predict" else T.PREFIX
    other = () if kind == "predict" else ("train.backward",)
    events = list(t["events"])
    assert sync_ranges(events)
    for extra in ([], _gapped_kernels(events)):
        with_ranges = _profile.summarize(events + extra, prefix, t["untraced_s"], other)
        without = _profile.summarize(_without_ranges(events) + extra, prefix, t["untraced_s"],
                                     other)
        assert with_ranges == without
    # gaps open inside the ranges and are named by the op there, as before
    inner = {c.name for r in sync_ranges(events) for c in r.cpu_children}
    assert any(name.split(": ")[-1] in inner for name, _ in with_ranges["idle_gaps"])
