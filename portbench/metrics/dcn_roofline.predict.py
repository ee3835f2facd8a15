"""The deformable convs' share of their roofline in the predict step: the
least time of their work (``_flops.dcn_least_s``: x, offsets and weights
read once, the output written once; the GEMM at the bf16 peak and the
offset conv at the float32 peak) over the device time of every kernel
launched inside the ``portbench.dcn`` ranges that the benchmark's hooks put
around each ``DeformConv`` forward."""

from portbench.metrics import _flops

LAYER = "ops and kernels: models/layers.py:DeformConv -> ops/deform_conv.py -> csrc"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    s, t = ctx.get("summary"), ctx.get("traced")
    if not s or not t or not s["dcn_device_ms"]:
        return None
    least_s, _ = _flops.dcn_least_s(ctx["model"], tuple(ctx["mix"]["bucket"]), t["images"])
    return 100.0 * least_s / (s["dcn_device_ms"] / 1e3)
