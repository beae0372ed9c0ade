"""The card's published peaks (NVIDIA's H100 SXM data sheet, dense rates
without sparsity, at the full power limit): int8 tensor-core operations
per second and HBM bytes per second. A share is stated against these,
with the card's power limit beside it."""

from __future__ import annotations

PEAKS = {"H100 SXM": (1979e12, 3.35e12)}


def card_peaks(name: str) -> tuple[str, float, float] | None:
    """``(table key, int8 op/s, bytes/s)`` for the card ``name`` (as
    ``torch.cuda.get_device_name`` gives it), or None for another card."""
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        return None
    return ("H100 SXM", *PEAKS["H100 SXM"])
