"""tswap_ops_per_step: device operations (kernels, copies, fills) of the
traced window whose start falls inside one of the program's ``mapd.tswap``
spans, per step.  The span opens after the replan's last host sync and
closes on the cascade's last, so every operation that starts inside it is
the TSWAP step's own: the goal-swap rounds and the movement phase."""

from tswap_bench import progtrace


def read(win):
    return progtrace.ops_per_step(win, "mapd.tswap")
