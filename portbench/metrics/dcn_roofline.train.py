"""The deformable convs' share of their roofline in the training step: the
least time of one forward pass of their work at each profiled step's
bucket (``_flops.dcn_least_s``) over the device time of every kernel
launched inside the ``portbench.dcn`` ranges around each ``DeformConv``
forward, the recompute's included: its time counts, its work does not."""

from portbench.metrics import _flops

LAYER = "ops and kernels: models/layers.py:DeformConv -> ops/deform_conv.py -> csrc"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    s, t = ctx.get("summary"), ctx.get("traced")
    if not s or not t or not s["dcn_device_ms"]:
        return None
    batch = t["images"] // t["steps"]
    least = sum(_flops.dcn_least_s(ctx["model"], tuple(b), batch)[0] for b in t["buckets"])
    return 100.0 * least / (s["dcn_device_ms"] / 1e3)
