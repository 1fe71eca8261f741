"""replan_ms_per_step: host-clock ms inside the program's in-step replan
(``mapd._replan``, the drain of the fields whose goal changed) over the
window, per step.  The drain ends in the host sync of its last chunk test,
so its device work is done when the span closes.  The prime (the first
step's ``prime_fields``) is not in it."""

SPANS = {"replan": "p2p_distributed_tswap_tpu_torch.solver.mapd:_replan"}


def read(win):
    seconds, calls = win.spans["replan"]
    if not win.step_s or not calls:
        return None
    return 1000.0 * seconds / len(win.step_s)
