"""Published peaks of the devices a run may report, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the card's
full 700 W power limit: 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM3.  A
device that is not in the table has no peak, and the shares read from it
are left out of the result, never given as 0."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flop_per_s": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def for_device(name: str | None) -> dict | None:
    return PEAKS.get(name) if name else None
