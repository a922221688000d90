"""The card a measurement runs on.

Timings mean something only on the accelerator, so measuring entry points
refuse any other backend instead of falling back to the CPU, and report
the card's name and power limit (a card capped below its maximum runs
slower under load) beside every number.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_cards() -> list[str]:
    """``name, power.limit`` of each card as nvidia-smi prints them, read
    by a child process that never touches JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()] or [
        f"nvidia-smi gave no card (rc {out.returncode})"
    ]


def power_limit_w(card: str) -> float | None:
    """The watts in an ``nvidia_smi_cards`` entry, or None."""
    try:
        return float(card.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


def require_gpu():
    """JAX's devices, or RuntimeError unless the first one is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"need a GPU; JAX sees {len(devs)} {devs[0].platform} "
            f"device(s) ({devs[0].device_kind})"
        )
    return devs
