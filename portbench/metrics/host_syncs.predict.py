"""Blocking reads per request (a batch of the mix's images): the program's
host ``sync.<site>`` ranges in the profiled stretch over its requests
(``_syncs.py``). Each is one point where the host waits for the card and its
queue of work drains. The count is the same traced and untraced; the
recorded phase slows the host around it, so the wait at each read
(``sync_wait_ms.predict``) reads low."""

from portbench.metrics._syncs import per_unit

LAYER = "entry: evaluation/inference.py:predict_step"
UNIT = "syncs/request"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "predict_img_per_s"


def read(ctx):
    return per_unit(ctx, "requests", wait=False)
