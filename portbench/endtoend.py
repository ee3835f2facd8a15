"""The end-to-end metrics, each from a run's window record and set-up time.

A window record (a driver's ``window``) holds every request's latency on the
host clock (``latencies_s``), the images completed (``images``), the steps
completed (``steps``), the window's length from its start to the last
completion (``window_s``) and the card's allocation peak over the window
(``memory_peak_bytes``). Rates are over all the work and all the time of the
window; a percentile is over every request of it.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q`` % of
    the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


METRICS = {
    "predict_img_per_s": lambda w, setup_s: w["images"] / w["window_s"],
    "predict_p95_ms": lambda w, setup_s: percentile(w["latencies_s"], 95) * 1e3,
    "train_img_per_s": lambda w, setup_s: w["images"] / w["window_s"],
    "train_peak_gib": lambda w, setup_s: w["memory_peak_bytes"] / 2 ** 30,
    "setup_s": lambda w, setup_s: setup_s,
}


def compute(names, window: dict, setup_s: float) -> dict:
    return {n: METRICS[n](window, setup_s) for n in names}
