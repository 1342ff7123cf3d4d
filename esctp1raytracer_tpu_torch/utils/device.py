"""Where a script runs, and what it runs on.

The scripts run on the card unless the caller asks for the CPU
(`--device cpu`, as the tests do). `require` refuses a CUDA run on a host
without a card: there is no quiet CPU fallback. `card` is the card's name
and power limit as `nvidia-smi` gives them, written beside every number a
script keeps (a card set below its maximum power runs slower under load).
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

DEVICES = ("cuda", "cpu")


def require(device: str) -> None:
    """Raise SystemExit (non-zero) when `device` is "cuda" and no card is visible."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("No CUDA device: this script runs on the card unless --device cpu "
                         "is given")


def kind(device: str) -> str:
    """torch's name of the device: the card's, or "cpu"."""
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def card(device: str) -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None on the CPU."""
    if device != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def synchronize(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def reset_peak(device: str) -> None:
    """Start a peak-memory window on the card (the card synchronised first)."""
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_gib(device: str) -> Optional[float]:
    """The card's peak allocated memory since `reset_peak`, GiB (None on the CPU)."""
    return torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
