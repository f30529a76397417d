"""Device identity and wall-clock timing for the benchmark scripts.

A time taken here is a device time only when the platform is a GPU:
`require_gpu` stops a measurement that would otherwise fall back to the
CPU, and `card_line` names the card and its power limit, which every
reported number carries (a card below its maximum power limit runs
slower under load).
"""
from __future__ import annotations

import subprocess
import time

import numpy as np

__all__ = ["require_gpu", "device_summary", "card_line", "time_call"]


def require_gpu():
    """Exit nonzero unless JAX's default device is a GPU."""
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {d.platform!r} "
                         f"({d.device_kind}); refusing to measure")
    return d


def device_summary() -> dict:
    """{"platform", "kind", "count"} as JAX reports the devices."""
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as it prints it (one
    line per card), or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or out.stderr.strip()


def time_call(fn, *args, reps: int = 5):
    """Median and all wall-clock seconds of `fn(*args)` over `reps` runs,
    each ended by `block_until_ready` (JAX returns before the device is
    done). The first call (compile + run) is not counted."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts
