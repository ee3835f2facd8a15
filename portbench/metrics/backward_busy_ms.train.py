"""Device busy ms per image of the backward pass: the kernels between the
device ranges of the stages before and after the program's
``train.backward`` range (autograd launches them from its own thread, so
the range itself holds none), as the program's ``chip_smoke.py:
phase_profile`` takes it."""

LAYER = "stages: train/step.py train.<stage> ranges"
UNIT = "ms/image"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_img_per_s"


def read(ctx):
    s, t = ctx.get("summary"), ctx.get("traced")
    if not s or not t:
        return None
    busy = s["stage_busy_ms"].get("train.backward")
    return busy / t["images"] if busy else None
