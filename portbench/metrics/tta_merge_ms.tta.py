"""Host ms per image inside the program's ``tta.merge`` and ``tta.fuse``
ranges (``upsnet_torch/evaluation/tta.py``): each variant's semantic logits
cropped, de-flipped and resized to the frame on the host, its detections
mapped back, the per-class NMS over all of them, and the fusion (its copies
to the card, ``panoptic_fuse``, the reads back and the resize to the frame).
A program without the ranges leaves nothing to read."""

LAYER = "tta: evaluation/tta.py predict_image_tta tta.<stage> ranges"
UNIT = "ms/image"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "predict_img_per_s"


def read(ctx):
    s, t = ctx.get("summary"), ctx.get("traced")
    if not s or not t:
        return None
    host = s["stage_host_ms"]
    if "tta.merge" not in host and "tta.fuse" not in host:
        return None
    return (host.get("tta.merge", 0.0) + host.get("tta.fuse", 0.0)) / t["images"]
