"""replan_ops_per_step: device operations (kernels, copies, fills) of the
traced window whose start falls inside one of the program's
``mapd.replan`` spans, per step.  The span opens after the assignment's
idle test (a host sync) and closes on the replan's last drain test, so
every operation that starts inside it is the in-step replan's own: each
chunk's fixpoint rounds, its direction fold and its row writes."""

from tswap_bench import progtrace


def read(win):
    return progtrace.ops_per_step(win, "mapd.replan")
