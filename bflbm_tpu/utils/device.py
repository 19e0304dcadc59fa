"""The accelerator a measurement runs on: check, describe, peak table."""

from __future__ import annotations

import subprocess

import jax

# Published HBM bandwidth by jax device_kind (NVIDIA H100 SXM data sheet:
# 80 GB HBM3 at 3.35 TB/s, at the full 700 W power limit).
PEAK_HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def require_gpu():
    """The first device, or SystemExit when JAX found no GPU: a
    measurement never falls back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform!r} "
                         f"({dev.device_kind})")
    return dev


def nvidia_smi() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them (read
    in a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def describe() -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
