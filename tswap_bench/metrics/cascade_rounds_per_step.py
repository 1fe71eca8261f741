"""cascade_rounds_per_step: the movement cascade's rounds (the program's
``solver/step.py`` ``cascade_rounds``, a host sync each) over the window,
per step."""

from tswap_bench import progtrace

CALLS = progtrace.CALLS


def read(win):
    rounds = progtrace.counter(win, "cascade_rounds")
    if rounds is None or not win.step_s:
        return None
    return rounds / len(win.step_s)
