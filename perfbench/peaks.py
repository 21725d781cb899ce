"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives: the HBM bandwidth of NVIDIA's data
sheet (SXM part, at the full 700 W power limit)."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak(kind: str, key: str) -> float | None:
    return PEAKS.get(kind, {}).get(key)
