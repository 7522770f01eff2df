"""The device rule of dtown_torch's entry points."""
from __future__ import annotations

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
