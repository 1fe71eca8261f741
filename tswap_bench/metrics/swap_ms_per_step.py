"""swap_ms_per_step: host-clock ms inside the program's ``step.swap``
spans over the window, per step: the occupancy and the ``swap_rounds``
rounds of Rule 3 and Rule 4 (the blocking-graph walks of ``cycle_cap``
hops), launched with no host sync."""

from tswap_bench import progtrace


def read(win):
    return progtrace.span_ms_per_step(win, "step.swap")
