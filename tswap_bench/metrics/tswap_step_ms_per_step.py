"""tswap_step_ms_per_step: host-clock ms inside the program's TSWAP step
(``step_parallel``: the goal-swap rounds and the movement cascade, a host
sync each cascade round) over the window, per step."""

SPANS = {"step": "p2p_distributed_tswap_tpu_torch.solver.mapd:step_parallel"}


def read(win):
    seconds, calls = win.spans["step"]
    if not win.step_s or not calls:
        return None
    return 1000.0 * seconds / len(win.step_s)
