"""Run one cell of the benchmark once, on the card.

    python3 tswap_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Sets up the cell (grid, inputs, warm-up),
measures for ``--seconds``, checks what the window produced against the
plain reference, and prints one JSON object as the last line of standard
output (the numbers compared, each beside its limit, are also the last
lines of standard error).  With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones, read from a
device trace and host spans.  Exits 2 without a CUDA card (it never runs
on the CPU) and 3 if the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The ``perf_counter`` reading at the process's start, from its start
    time in ``/proc`` (to a clock tick): set-up counts the interpreter's
    start-up too."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now
    return now - age


PROCESS_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a checkout builds (the program builds its CUDA library
# under build/torch_kernels/ itself).
_CACHE = ROOT / "build" / "tswap_bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(_CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("tswap_bench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    from tswap_bench import harness

    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device, PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print(f"tswap_bench: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
