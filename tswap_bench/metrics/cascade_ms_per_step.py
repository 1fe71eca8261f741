"""cascade_ms_per_step: host-clock ms inside the program's
``step.cascade`` spans over the window, per step: the movement phase, its
mutual swaps and the cascade's rounds, a host sync each; the span closes on
the last round's sync, so the step's device work is done by then."""

from tswap_bench import progtrace


def read(win):
    return progtrace.span_ms_per_step(win, "step.cascade")
