"""The card: the look for it, its description, its power limit."""
from __future__ import annotations

import subprocess


def missing(torch, chips: int) -> str | None:
    """Why this machine cannot run a cell of ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}"
    return None


def power_limit_w() -> float | None:
    """The card's power limit as nvidia-smi reads it (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(torch, chips: int, device: str) -> dict:
    """The result's ``device``: platform, name, count, the fullest card's
    peak of allocated memory, the power limit."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0,
                "power_limit_w": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips)),
            "power_limit_w": power_limit_w()}
