"""Device checks for the scripts that measure on the card.

`bench.py`, `benchmarks/run_all.py`, `benchmarks/gate.py` and
`chip_smoke.py` time the program on an NVIDIA GPU. A time taken anywhere
else describes the CPU backend or the Pallas interpreter, so these scripts
refuse to run there instead of falling back.
"""

from __future__ import annotations

import subprocess


def require_gpu(count: int = 1):
    """Return the first `count` JAX devices; exit non-zero unless they are
    GPUs. Call before any other work."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"this script measures on an NVIDIA GPU; JAX found platform "
            f"{platform!r} ({devices[0].device_kind})")
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs; JAX found {len(devices)}")
    return devices[:count]


def device_record(count: int | None = None) -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices) if count is None else count}


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them (one line
    per card), or a note saying why they could not be read. Runs
    nvidia-smi as a child process that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip()
