"""Published peak rates of the cards the benchmark knows.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bfloat16, 67 TFLOP/s in float32 off
the tensor cores (TF32 off), 3.35 TB/s of HBM3.  A card set below 700 W
runs slower under load; the run prints the limit beside every reading.
"""

from __future__ import annotations

H100_SXM = {"bfloat16": 989e12, "float32": 67e12, "hbm_bytes_s": 3.35e12}

#: By the name ``torch.cuda.get_device_name`` gives.
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def for_device(name: str) -> dict | None:
    """The card's peaks, or None for a card not on record."""
    return PEAKS.get(name)
