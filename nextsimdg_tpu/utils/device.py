"""What the program runs on, as JAX and the card's driver report it."""

from __future__ import annotations

import shutil
import subprocess


def device_summary() -> dict:
    """Platform, device kind and device count of JAX's default backend."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each NVIDIA card, one line per card, as
    ``nvidia-smi`` prints them; "not available" without ``nvidia-smi``."""
    if shutil.which("nvidia-smi") is None:
        return "not available"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
