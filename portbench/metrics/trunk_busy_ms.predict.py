"""Device busy ms per image of the kernels launched inside the program's
``predict.trunk`` range (backbone, FPN, RPN head, FCN head)."""

LAYER = "stages: models/upsnet.py predict.<stage> ranges"
UNIT = "ms/image"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "predict_img_per_s"


def read(ctx):
    s, t = ctx.get("summary"), ctx.get("traced")
    if not s or not t:
        return None
    busy = s["stage_busy_ms"].get("predict.trunk")
    return busy / t["images"] if busy else None
