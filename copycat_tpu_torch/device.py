"""Device selection and card identification for the port's entry points."""

from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for ``cuda`` without a card raises — no entry point
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), one line per card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30)
    return out.stdout.strip()
