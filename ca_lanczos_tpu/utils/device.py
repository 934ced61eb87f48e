"""Device checks shared by the measuring entry points (``bench.py``,
``chip_smoke.py``): they run on a GPU or not at all, and every result
they print names the card it ran on."""

from __future__ import annotations

import subprocess
from typing import List

import jax


def require_gpu() -> List[jax.Device]:
    """The visible JAX devices; raises SystemExit (non-zero, nothing on
    stdout) unless JAX's first device is a GPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devices[0].platform!r} "
            f"({devices[0].device_kind}); refusing to measure"
        )
    return devices


def card_info() -> List[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card
    (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``); a card below its maximum
    power limit runs slower under load, so measurements carry this."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [ln.strip() for ln in out.splitlines() if ln.strip()]
