"""The device rule of dtown_torch's entry points."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA must be present when asked for
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "torch versions instead of the CUDA kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def describe(dev: torch.device) -> str:
    """What a measurement ran on: the card's name and power limit, or
    "cpu"."""
    return nvidia_smi_line() if dev.type == "cuda" else "cpu"
