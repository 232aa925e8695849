"""The device a measurement runs on.

Every number this repository reports as a device time comes from a GPU:
the entry points that measure refuse any other backend instead of falling
back to the CPU, and print the card beside their results.
"""
from __future__ import annotations

import subprocess


def require_gpu(devices) -> None:
    """Exit unless the first JAX device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"needs a GPU, JAX found '{plat}'")


def card_info() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi gave nothing (rc {out.returncode})"


def describe(devices) -> str:
    """One line naming the JAX device, the device count and the card."""
    d = devices[0]
    return (f"{d.platform} {d.device_kind}, {len(devices)} device(s); "
            f"nvidia-smi: {card_info()}")
