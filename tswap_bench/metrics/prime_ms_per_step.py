"""prime_ms_per_step: host-clock ms inside the program's ``mapd.prime``
spans over the window, per step: each solve's prime of every agent's
field in ``prepare_state`` (``replan_chunk``-wide chunks, a host sync
each fixpoint round), which counts in the solve's first step."""

from tswap_bench import progtrace


def read(win):
    return progtrace.span_ms_per_step(win, "mapd.prime")
