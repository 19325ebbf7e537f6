"""What a measurement record says about the device it ran on."""
from __future__ import annotations

import subprocess
from typing import Dict

import jax


def device_record() -> Dict:
    """Platform, device kind and count as JAX reports them."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (first card).  Raises if nvidia-smi cannot answer."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu() -> Dict:
    """The device record; raises unless JAX runs on an NVIDIA GPU (a
    measurement never falls back to the CPU)."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise RuntimeError(
            "no GPU: JAX runs on {platform!r} ({kind}); device numbers are "
            "taken on an NVIDIA GPU only".format(**rec))
    return rec
