"""Per-direction times of the sweep kernel against another version of its
source, in one process on one NVIDIA GPU, and of its forced layouts.

Run from the root of a checkout on a machine with the card:

    python3 analysis/sweep_compare.py --baseline OTHER/csrc/sweep_scan.cu
        [--layouts] [--out FILE]

``OTHER`` is any other checkout of the port (for instance an earlier commit
unpacked with ``git archive`` into ``build/``).  Its ``sweep_scan.cu`` is
compiled on its own by ``nvcc`` into ``build/sweep_baseline/`` and bound
through the same C entry ``sweep_scan``; the checkout's kernels are built as
the port builds them.  At each timed shape of ``chip_smoke.py``'s kernel
phase (the in-step and prime chunks of the 1024^2, 512^2 and 256^2 rungs,
on their own grids, with chip_smoke.py's inputs) and in each direction,
both versions are held to ``sweep_plain`` (``torch.equal``) and timed in
turns, baseline, current, current, baseline, each turn chip_smoke.py's
measurement (5 runs of 25 launches queued behind a device sleep, CUDA
events), so each version has 10 runs.  With ``--layouts`` every forced
layout is checked and timed too (the current source only, 5 runs): the
chosen one (``sweep_kernel.launch_layout``) and the alternatives of
``LAYOUTS``, along H other tile widths, band heights and band counts (one
band of 8 rows a block is a plain walk down each column in steps of 8),
along W one cell per lane (scalar loads) against the chosen four.

Prints one JSON line per row, then one with the card; ``--out`` writes the
rows as one JSON object.  Exits non-zero without a card, or when a version
differs from the plain sweep.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from p2p_distributed_tswap_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    sweep_kernel,
)

BUILD = REPO / "build" / "sweep_baseline"
TIMED = [case[:4] for case in chip_smoke.KERNEL_CASES if case[4]]
# Forced layouts timed beside the chosen one: (R, H, W) -> along-H (tile,
# rows, bands) triples; along W one cell per lane at every shape.
LAYOUTS = {
    (4, 1024, 1024): [(32, 8, 32), (32, 16, 16), (16, 16, 64), (16, 8, 64),
                      (32, 16, 8), (32, 8, 1)],
    (64, 1024, 1024): [(32, 16, 32), (32, 16, 16), (32, 16, 4), (32, 8, 4),
                       (16, 16, 16), (32, 8, 1)],
    (4, 512, 512): [(16, 8, 64), (16, 8, 32), (8, 16, 32), (32, 16, 32),
                    (16, 16, 8), (32, 8, 1)],
    (128, 512, 512): [(32, 16, 32), (32, 16, 16), (32, 16, 4), (32, 8, 4),
                      (16, 16, 16), (32, 8, 1)],
    (4, 256, 256): [(8, 8, 32), (16, 16, 16), (16, 8, 32), (8, 16, 8),
                    (32, 8, 1)],
    (64, 256, 256): [(32, 16, 16), (32, 8, 32), (16, 16, 16), (32, 16, 4),
                     (32, 8, 4), (32, 8, 1)],
}
W_LAYOUTS = [{"tile": 1}]


def forced_layouts(r: int, h: int, w: int, axis: int) -> list:
    """The chosen layout as forced arguments, then the alternatives."""
    chosen = sweep_kernel.launch_layout(r, h, w, axis)
    if axis == 2:
        return [{"tile": chosen["cells"]}] + W_LAYOUTS
    return [{"tile": chosen["tile"], "rows": chosen["rows"],
             "bands": chosen["bands"]}] + [
        {"tile": t, "rows": b, "bands": n} for t, b, n in LAYOUTS[(r, h, w)]]


def build_baseline(source: Path) -> ctypes.CDLL:
    """Compile ``source`` alone into a shared library, as cuda_build does."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libsweep_baseline.so"
    out = subprocess.run(
        [cuda_build._nvcc(), "-gencode", cuda_build._ARCH, "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
         str(lib), str(source)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"sweep_compare: nvcc failed:\n{out.stderr}")
    print(json.dumps({"baseline_build": str(source),
                      "ptxas": out.stderr.strip()}), flush=True)
    return ctypes.CDLL(str(lib))


def baseline_sweep(lib: ctypes.CDLL):
    fn = lib.sweep_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def sweep(d, blocked, axis, reverse):
        out = torch.empty_like(d)
        r, h, w = d.shape
        rc = fn(d.data_ptr(), blocked.data_ptr(), out.data_ptr(), r, h, w,
                axis, int(reverse), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline sweep_scan: CUDA error {rc}")
        return out
    return sweep


def _equal(fn, want) -> bool:
    got = fn()
    torch.cuda.synchronize()
    return bool(torch.equal(got, want))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another version's csrc/sweep_scan.cu")
    ap.add_argument("--layouts", action="store_true",
                    help="also time the forced layouts of LAYOUTS")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_compare: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cuda_build.build()
    versions = {"baseline": baseline_sweep(build_baseline(args.baseline)),
                "current": sweep_kernel.sweep_scan}
    rows, ok = [], True
    rng = np.random.default_rng(0)  # the timed cases draw nothing from it
    for r, h, w, kind in TIMED:
        d, blocked = chip_smoke.sweep_inputs(dev, r, h, w, kind, rng)
        bound = chip_smoke.sweep_bound(r, h, w)
        for axis, reverse in chip_smoke.DIRECTIONS:
            want = sweep_kernel.sweep_plain(d, blocked, axis, reverse)
            calls = {name: (lambda fn=fn: fn(d, blocked, axis, reverse))
                     for name, fn in versions.items()}
            row = {"shape": [r, h, w], "mask": kind, "axis": axis,
                   "reverse": reverse, **bound,
                   "layout": sweep_kernel.launch_layout(r, h, w, axis)}
            runs = {name: [] for name in calls}
            for name in ("baseline", "current", "current", "baseline"):
                runs[name] += chip_smoke._launch_ms_runs(
                    calls[name], chip_smoke.TIMED_LAUNCHES)
            for name, fn in calls.items():
                row[f"{name}_equal"] = _equal(fn, want)
                row[f"{name}_ms"] = statistics.median(runs[name])
                row[f"{name}_ms_runs"] = runs[name]
                ok = ok and row[f"{name}_equal"]
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not args.layouts or not reverse:
                continue  # the forced layouts once per axis, both ways
            for reverse_f in (False, True):
                for lay in forced_layouts(r, h, w, axis):
                    def fn(lay=lay, reverse_f=reverse_f):
                        return sweep_kernel.sweep_scan_forced(
                            d, blocked, axis, reverse_f, **lay)
                    want_f = sweep_kernel.sweep_plain(d, blocked, axis,
                                                      reverse_f)
                    ms_runs = chip_smoke._launch_ms_runs(
                        fn, chip_smoke.TIMED_LAUNCHES)
                    lrow = {"shape": [r, h, w], "axis": axis,
                            "reverse": reverse_f, "forced": lay,
                            "layout": sweep_kernel.launch_layout(
                                r, h, w, axis, **lay),
                            "equal": _equal(fn, want_f),
                            "ms": statistics.median(ms_runs),
                            "ms_runs": ms_runs,
                            "bound_ms": bound["bound_ms"]}
                    ok = ok and lrow["equal"]
                    rows.append(lrow)
                    print(json.dumps(lrow), flush=True)
    print(json.dumps({"card": card, "torch_name":
                      torch.cuda.get_device_name(0), "all_equal": ok}),
          flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
