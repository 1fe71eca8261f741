"""device_idle: the share of the traced window, in %, in which no
operation (kernel, copy, fill) ran on the device: 1 minus the union of the
device timeline's operations over the window's length."""

from tswap_bench import devtrace


def read(win):
    if win.trace is None or win.trace_hi <= win.trace_lo:
        return None
    busy = devtrace.busy_ns(win.trace.events, win.trace_lo, win.trace_hi)
    if busy == 0:
        return None
    return 100.0 * (1.0 - busy / (win.trace_hi - win.trace_lo))
