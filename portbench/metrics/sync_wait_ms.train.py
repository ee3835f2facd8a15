"""Host ms per train step spent inside the program's ``sync.<site>``
ranges of the profiled stretch (``_syncs.py``): time the host waited
for the card instead of queueing work. The recorded phase slows the host,
so less work is queued ahead of each read than untraced and the wait reads
low against an untraced run."""

from portbench.metrics._syncs import per_unit

LAYER = "model step: forward_train + backward + train/optimizer.py"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_img_per_s"


def read(ctx):
    return per_unit(ctx, "steps", wait=True)
