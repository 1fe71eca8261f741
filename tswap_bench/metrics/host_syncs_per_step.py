"""host_syncs_per_step: the program's counted device-to-host reads
(``hostsync.count``: every fixpoint round, assignment round, replan chunk,
movement round and finish test) over the window, per step."""

COUNTERS = {"host_syncs": "p2p_distributed_tswap_tpu_torch.hostsync:count"}


def read(win):
    if not win.step_s:
        return None
    return win.counters["host_syncs"] / len(win.step_s)
