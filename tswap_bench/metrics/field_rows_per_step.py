"""field_rows_per_step: the direction-field rows the program computed over
the window (``solver/mapd.py`` ``field_rows``: the chunk width for every
chunk of the in-step replan and of each solve's prime, clipped lanes
included), per step."""

from tswap_bench import progtrace

CALLS = progtrace.CALLS


def read(win):
    rows = progtrace.counter(win, "field_rows")
    if rows is None or not win.step_s:
        return None
    return rows / len(win.step_s)
