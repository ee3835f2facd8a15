"""One less the card's busy time in the profiled stretch (the union of its
kernels' intervals) over the wall time of the same stretch run untraced, in
a predict window."""

LAYER = "device"
UNIT = "share"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    s = ctx.get("summary")
    if not s or not s["n_ops"]:
        return None
    return s["idle_share"]
