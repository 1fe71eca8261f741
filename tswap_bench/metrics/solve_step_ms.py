"""solve_step_ms: the window's host seconds over every MAPD step taken in
it, in ms.  Each solve's prepare (assignment and prime) counts in its first
step, so the window is exactly the sum of its steps."""


def read(win):
    if not win.step_s:
        return None
    return 1000.0 * win.window_s / len(win.step_s)
