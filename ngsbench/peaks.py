"""Published peaks of the cards the benchmark knows, by the name that
torch.cuda.get_device_name() gives (NVIDIA's data sheet, SXM part). A
roofline share is stated against these, at the card's full power limit; a
card set lower reads lower."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str) -> float | None:
    """The named peak of the card, or None for a card not in the table."""
    return PEAKS.get(device_name, {}).get(key)
