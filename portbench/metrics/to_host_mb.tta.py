"""MB (10^6 bytes) per image that the program copied from the card to the
host in the untraced run of the profiled stretch, as its ``host_sync`` sites
count them (``upsnet_torch/utils/profiling.py:read_bytes``): each variant's
full float32 semantic logits and detections, and the fusion's map and keep
flags. A program without the counter leaves nothing to read."""

LAYER = "tta: evaluation/tta.py predict_image_tta tta.<stage> ranges"
UNIT = "MB/image"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "predict_img_per_s"


def read(ctx):
    t = ctx.get("traced")
    if not t or t.get("to_host_bytes") is None or not t.get("images"):
        return None
    return t["to_host_bytes"] / t["images"] / 1e6
