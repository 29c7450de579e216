"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives. NVIDIA's data sheet, H100 SXM,
dense rates without sparsity, at the full 700 W power limit."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flop_per_s": 67e12,      # outside the tensor cores
        "tf32_flop_per_s": 495e12,
        "bf16_flop_per_s": 989e12,
        "memory_bytes": 80e9,
    },
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)
