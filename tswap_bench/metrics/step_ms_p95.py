"""step_ms_p95: the 95th percentile, in ms, of the host-clock time of every
step of the window, each step from one step boundary (the host sync of the
solve's finish test) to the next, a solve's prepare in its first step.
Linear interpolation between order statistics (numpy's default)."""

import numpy as np


def read(win):
    if not win.step_s:
        return None
    return 1000.0 * float(np.percentile(np.asarray(win.step_s), 95))
