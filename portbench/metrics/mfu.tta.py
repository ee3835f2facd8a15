"""The TTA evaluation's share of the card's bf16 peak: the model's operations
of every variant's forward at its canvas (``_flops.predict_flops``; the
configuration's ``test.scales`` and ``multi_scale``, each unflipped and,
under ``flip_test``, flipped: six forwards an image at 1024x2048 in the
Cityscapes file) times the images per second of the profiled stretch run
untraced, over 989 TFLOP/s."""

from portbench.metrics import _flops
from portbench.reference.tta_ref import variant_canvas, variants

LAYER = "model step: models/upsnet.py:forward_predict"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def image_flops(model: dict, frame) -> float:
    test = model["test"]
    return sum(_flops.predict_flops(model, variant_canvas(*frame, s, test)[2])
               for s, _ in variants(test))


def read(ctx):
    t = ctx.get("traced")
    if not t or not ctx.get("summary") or not ctx["summary"]["n_ops"]:
        return None
    flops = image_flops(ctx["model"], tuple(ctx["mix"]["frame"])) * t["images"]
    return 100.0 * flops / t["untraced_s"] / _flops.BF16_FLOPS
