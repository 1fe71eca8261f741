"""Readings that set the limits of the correctness check, on the card.

    python3 tswap_bench/control.py --workload <cell> --seeds 1,2,3
        --seconds <s> [--control | --fault <name>]

runs the cell once per seed in this one process (set-up, a window of
``--seconds``, the cut solve finished, the check) and prints one JSON line
per seed with the numbers compared and the most movement-cascade rounds
any step took (the program's cap is ``max_move_rounds``).  Without an
option it reads the program as it is (the lower readings); with
``--control``, the reference's field computation in bfloat16 takes the
place of the program's (``reference/control.py``; the upper readings);
with ``--fault``, one of ``faults.py``'s planted faults.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

FIELDS = "p2p_distributed_tswap_tpu_torch.solver.mapd:direction_fields"
CASCADE = "p2p_distributed_tswap_tpu_torch.solver.step:_cascade"


def counted_cascade(rounds: list):
    """The program's movement cascade, each call's rounds (its host
    syncs) appended to ``rounds``."""
    from p2p_distributed_tswap_tpu_torch import hostsync
    from p2p_distributed_tswap_tpu_torch.solver import step

    cascade = step._cascade

    def counted(*args, **kw):
        before = hostsync.count
        out = cascade(*args, **kw)
        rounds.append(hostsync.count - before)
        return out
    return counted


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    from tswap_bench import faults, harness
    from tswap_bench.reference import control

    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        rounds: list = []
        patches = {CASCADE: counted_cascade(rounds)}
        if args.control:
            patches[FIELDS] = control.direction_fields
        if args.fault:
            target, fn, _ = faults.FAULTS[args.fault]
            patches[target] = fn
        t0 = time.perf_counter()
        r = harness.run(ROOT, args.workload, seed, args.seconds, False,
                        device, t0, patches=patches)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "failed": r["failed"], "checks": r["checks"],
                          "max_cascade_rounds": max(rounds, default=0),
                          "cascades": len(rounds),
                          "metrics": r["metrics"],
                          "run_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
