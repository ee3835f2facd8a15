"""Blocking reads per train step: the program's host ``sync.<site>``
ranges in the profiled stretch over its steps (``_syncs.py``). Each is
one point where the host waits for the card and its queue of work drains.
The count is the same traced and untraced; the recorded phase slows the
host around it, so the wait at each read (``sync_wait_ms.train``) reads
low."""

from portbench.metrics._syncs import per_unit

LAYER = "model step: forward_train + backward + train/optimizer.py"
UNIT = "syncs/step"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_img_per_s"


def read(ctx):
    return per_unit(ctx, "steps", wait=False)
