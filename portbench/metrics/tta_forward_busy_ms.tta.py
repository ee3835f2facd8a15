"""Device busy ms per image of the kernels and copies that start inside the
program's host ``tta.predict`` ranges (``upsnet_torch/evaluation/tta.py``):
every variant's predict step, the sample's copy to the card and the outputs'
copies back included. Each range ends with the predict step's reads back,
which wait for its work, so its kernels start and end inside it. (The
profiler gives each kernel to the innermost range that launched it, so the
device span of ``tta.predict`` itself holds only the sample's copies.) A
program without the ranges leaves nothing to read."""

import bisect

from torch.autograd import DeviceType

LAYER = "tta: evaluation/tta.py predict_image_tta tta.<stage> ranges"
UNIT = "ms/image"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "predict_img_per_s"
RANGE = "tta.predict"


def read(ctx):
    t = ctx.get("traced")
    if not t or not t.get("images"):
        return None
    events = t["events"]
    host = [e for e in events if e.device_type != DeviceType.CUDA and e.is_user_annotation]
    ranges = sorted((e.time_range.start, e.time_range.end) for e in host if e.name == RANGE)
    if not ranges:
        return None
    names = {e.name for e in host}
    starts = [s for s, _ in ranges]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.name not in names]
    if not kernels:
        return None
    busy_us = 0.0
    for e in kernels:
        k = bisect.bisect_right(starts, e.time_range.start) - 1
        if k >= 0 and e.time_range.start <= ranges[k][1]:
            busy_us += e.time_range.elapsed_us()
    return busy_us / 1e3 / t["images"]
