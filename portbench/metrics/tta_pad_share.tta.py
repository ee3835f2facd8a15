"""The share of the TTA forwards' input canvases that is padding: one less
the content pixels inside each canvas, ``min(rh, bh)·min(rw, bw)``, over the
canvas pixels ``bh·bw``, summed over every variant the program ran (its
``upsnet_torch/utils/profiling.py:read_canvas`` tally). The mix draws every
frame at one size, so each image adds the same share. A program without the
tally, or one that has counted nothing, leaves nothing to read."""

LAYER = "tta: evaluation/tta.py predict_image_tta tta.<stage> ranges"
UNIT = "share"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "predict_img_per_s"


def read(ctx):
    from upsnet_torch.utils import profiling

    tally = getattr(profiling, "read_canvas", None)
    counts = None if tally is None else tally()
    if not counts or not counts.get("canvas"):
        return None
    return 1.0 - counts["inside"] / counts["canvas"]
