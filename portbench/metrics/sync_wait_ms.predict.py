"""Host ms per request (a batch of the mix's images) spent inside the
program's ``sync.<site>`` ranges of the profiled stretch (``_syncs.py``):
time the host waited for the card instead of queueing work. The recorded phase slows the host,
so less work is queued ahead of each read than untraced and the wait reads
low against an untraced run."""

from portbench.metrics._syncs import per_unit

LAYER = "entry: evaluation/inference.py:predict_step"
UNIT = "ms/request"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "predict_img_per_s"


def read(ctx):
    return per_unit(ctx, "requests", wait=True)
