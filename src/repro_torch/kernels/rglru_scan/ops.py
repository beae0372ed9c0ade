"""The chunked linear recurrence's wrapper, the port of
``repro/kernels/rglru_scan/ops.py``.

The reference jits its wrapper and passes the Pallas ``chunk`` and
``interpret`` through; PyTorch runs it eagerly and the Hopper kernel has
neither, so this is a plain call of the kernel's wrapper (the kernel on
CUDA tensors, its plain version on CPU tensors)."""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.kernel import linear_scan


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B,S,D] -> h [B,S,D] (fp32 recurrence, output dtype of b)."""
    return linear_scan(a, b)
