"""assign_ms_per_step: host-clock ms inside the program's ``mapd.assign``
spans over the window, per step: each step's idle test (a host sync) and,
when it runs, the assignment's rounds (a host sync each), and each solve's
first assignment in ``prepare_state``."""

from tswap_bench import progtrace


def read(win):
    return progtrace.span_ms_per_step(win, "mapd.assign")
