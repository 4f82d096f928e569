"""Data-sheet peaks of the card the cells run on (NVIDIA's H100 SXM5 data
sheet, dense rates without sparsity): device-memory bytes/s, bf16
tensor-core FLOP/s and float32 FLOP/s outside the tensor cores. Another
card reads no roofline or MFU until a row for it is added here."""

from __future__ import annotations

from typing import Optional

PEAKS = [
    # (name contains, bytes/s, bf16 flop/s, fp32 flop/s)
    ("H100 80GB HBM3", 3.35e12, 989e12, 67e12),  # SXM5
]


def card_peaks(name: str) -> Optional[dict]:
    """``{"bytes_per_s", "bf16_flops", "fp32_flops"}`` of the card, or None
    where the table has no row for it (the CPU among them)."""
    for key, bw, bf16, fp32 in PEAKS:
        if key in name:
            return {"bytes_per_s": bw, "bf16_flops": bf16, "fp32_flops": fp32}
    return None
