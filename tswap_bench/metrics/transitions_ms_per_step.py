"""transitions_ms_per_step: host-clock ms inside the program's
``mapd.transitions`` spans over the window, per step: the task phases'
pickup and delivery flips at the step's start, launched with no host
sync."""

from tswap_bench import progtrace


def read(win):
    return progtrace.span_ms_per_step(win, "mapd.transitions")
