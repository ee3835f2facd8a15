"""The training step's share of the card's bf16 peak: the model's operations
per image of each profiled step (``_flops.train_flops`` at that step's
bucket: forward, the weights' gradients and the inputs' gradients, the
recompute not counted) over the wall time of the profiled stretch run
untraced (the profiler's cost per op would slow the host), over
989 TFLOP/s."""

from portbench.metrics import _flops

LAYER = "model step: forward_train + backward + train/optimizer.py"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    t = ctx.get("traced")
    if not t or not ctx.get("summary") or not ctx["summary"]["n_ops"]:
        return None
    batch = t["images"] // t["steps"]
    flops = sum(_flops.train_flops(ctx["model"], tuple(b)) * batch for b in t["buckets"])
    return 100.0 * flops / t["untraced_s"] / _flops.BF16_FLOPS
