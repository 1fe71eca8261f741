"""sweep_scan_roofline: the share, in %, of ``sweep_scan``'s device time
that its launches' bytes need at the card's published HBM bandwidth: the
least time of every launch of the window (``roofline.sweep_scan_bytes`` of
its (R, H, W) and mask, over ``roofline.PEAKS``) summed, over the summed
device time of the kernel's launches in the trace (``sweep_along_h``,
``sweep_along_w``).  The card's power limit is in the result's ``device``.
Nothing to read (no launch, or launches the trace lost) gives no value."""

import sys

from tswap_bench import roofline

KERNELS = ("sweep_along_h", "sweep_along_w")


def _shape(d, blocked, axis, reverse, *rest, **kw):
    r, h, w = d.shape
    return r, h, w, blocked.dim() == 3


CALLS = {"sweep_scan": (
    "p2p_distributed_tswap_tpu_torch.ops.sweep_kernel:sweep_scan", _shape)}


def read(win):
    launches = win.calls["sweep_scan"]
    if win.trace is None or not launches:
        return None
    ns, seen = 0, 0
    for name, s, e in win.trace.events:
        if any(k in name for k in KERNELS):
            ns += e - s
            seen += 1
    if seen != len(launches) or ns <= 0:
        print(f"sweep_scan_roofline: {len(launches)} launches, {seen} in "
              "the trace", file=sys.stderr)
        return None
    least = sum(roofline.sweep_scan_bytes(*shape) for shape in launches) \
        / roofline.peak(win.card, "hbm_bytes_per_s")
    return 100.0 * least / (ns / 1e9)
