"""Device identification for measurement entry points.

A measurement names the device it ran on, and refuses to run anywhere else:
``require_gpu`` fails when JAX's default backend is not a GPU (no silent
fallback to the CPU), and ``card_line`` reads the card's name and power
limit, which bound the card's speed under load.
"""

from __future__ import annotations

import shutil
import subprocess


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card), or a note saying why it could not be read."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: failed ({e})"
    return out.strip()


def require_gpu() -> dict:
    """The device record ``{"platform", "kind", "count"}`` of the default
    backend; raises ``SystemExit`` unless it is a GPU."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {d.platform} "
                         f"({d.device_kind}); this measures the GPU only")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
