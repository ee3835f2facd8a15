"""Device operations (kernels, copies and fills) launched per request in the
profiled stretch of a serving window: what the host has to dispatch."""

LAYER = "entry: evaluation/inference.py:predict_step"
UNIT = "ops/request"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "predict_p95_ms"


def read(ctx):
    s, t = ctx.get("summary"), ctx.get("traced")
    if not s or not t or not s["n_ops"]:
        return None
    return s["n_ops"] / t["requests"]
