"""record_ms_per_step: host-clock ms inside the program's ``mapd.record``
spans over the window, per step: the step's positions and phases written
into the solve's path buffers, launched with no host sync."""

from tswap_bench import progtrace


def read(win):
    return progtrace.span_ms_per_step(win, "mapd.record")
