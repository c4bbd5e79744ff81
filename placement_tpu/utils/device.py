"""The accelerator a measurement runs on.

Measurements of this system are taken on an NVIDIA GPU. ``require_gpu``
refuses any other platform, so a run without the card fails instead of
timing the CPU, and ``card_description`` names the card and its power
limit, which sets the clock it can hold under load.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> jax.Device:
    """The first JAX device; raises ``RuntimeError`` unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"needs a GPU, but JAX's first device is {dev} "
            f"(platform {dev.platform!r})")
    return dev


def card_description() -> str:
    """``name, power.limit`` of each card, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
