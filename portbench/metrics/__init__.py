"""Per-layer metrics, one reader a file: ``metrics/<metric>.py``.

A reader declares ``LAYER``, ``UNIT``, ``BETTER``, ``SOURCE`` and ``MOVES``
as ``BENCHMARK.json`` gives them, and ``read(ctx)``, which returns the
metric's value from a traced run's context, or None where it finds nothing
to read (the harness then leaves the metric out of the result line). The
context holds ``summary`` (``_profile.summarize`` of the profiled stretch),
``traced`` (its requests or steps, images and wall seconds), ``model`` and
``mix`` (the cell's configuration and traffic files) and ``window`` (the
driver's window record). Files whose names start with ``_`` hold shared
arithmetic and are no metric.
"""

from __future__ import annotations

import importlib.util
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


def load(name: str):
    """The reader of metric ``name``, from ``metrics/<name>.py``."""
    path = HERE / f"{name}.py"
    if name.startswith("_") or not path.is_file():
        raise FileNotFoundError(f"no reader {path} for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_all(names, ctx: dict) -> dict:
    """{name: {"value", "unit"}} of every reader that found something."""
    out = {}
    for name in names:
        mod = load(name)
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out
