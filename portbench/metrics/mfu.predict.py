"""The predict step's share of the card's bf16 peak: the model's operations
per image (``_flops.predict_flops``: every conv and dense layer, the
deformable convs' GEMMs and offset convs included) times the images per
second of the profiled stretch run untraced (the profiler's cost per op
would slow the host), over 989 TFLOP/s."""

from portbench.metrics import _flops

LAYER = "model step: models/upsnet.py:forward_predict"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    t = ctx.get("traced")
    if not t or not ctx.get("summary") or not ctx["summary"]["n_ops"]:
        return None
    flops = _flops.predict_flops(ctx["model"], tuple(ctx["mix"]["bucket"])) * t["images"]
    return 100.0 * flops / t["untraced_s"] / _flops.BF16_FLOPS
