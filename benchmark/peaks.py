"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit).  A card that is not
in the table has no peaks, and the shares of a peak are then not read."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12,  # outside the tensor cores: TF32 is off
        "tf32": 495e12,
        "bfloat16": 989e12,
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks_for(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)
