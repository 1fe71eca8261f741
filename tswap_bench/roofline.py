"""The yardstick of the kernels' roofline shares: the card's published
peaks, and the bytes each kernel launch needs.

Peaks are NVIDIA's data sheet for one H100 SXM (80 GB HBM3), dense rates,
at the full 700 W power limit; a card set below it runs slower under load,
so every share is printed beside the card's reported power limit.

Bytes count each input read once and each output written once, whatever
the kernel reads again.
"""

from __future__ import annotations

# HBM bytes/s of one H100 SXM at 700 W.  A sweep's few integer operations
# a cell (at 67e12/s outside the tensor cores) bound it some 30 times below
# its bytes, so bytes alone set its least time.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "power_limit_w": 700.0},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peak(card: str, key: str) -> float:
    """A published peak of ``card`` (the H100 SXM's where the name is not
    in the table)."""
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])[key]


def sweep_scan_bytes(r: int, h: int, w: int, mask_per_field: bool) -> int:
    """Bytes one ``sweep_scan`` launch needs: the (R, H, W) int32
    distances read and written once, and the uint8 obstacle mask read
    once, one (H, W) plane shared by every field or one per field."""
    cells = r * h * w
    return 4 * cells + 4 * cells + (cells if mask_per_field else h * w)
