"""fixpoint_rounds_per_batch: the sweep fixpoint's rounds over its batches
in the window (``ops/distance.py`` ``fixpoint_rounds`` over
``fixpoint_batches``): four directional sweeps and a host sync a round,
one batch a chunk of fields of the replan or the prime."""

from tswap_bench import progtrace

CALLS = progtrace.CALLS


def read(win):
    rounds = progtrace.counter(win, "fixpoint_rounds")
    batches = progtrace.counter(win, "fixpoint_batches")
    if rounds is None or not batches:
        return None
    return rounds / batches
