"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit.  A card set below 700 W runs slower under load, so every
result line carries the card's name and power limit beside the shares of
these peaks.
"""

PEAKS = {
    "H100": {
        "bf16_flops": 989e12,
        "fp8_flops": 1979e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the card whose ``torch.cuda.get_device_name()`` is
    ``device_name``; raises for a card the table does not hold."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    raise KeyError(f"no published peaks for {device_name!r}")
