"""Device resolution for the port's entry points.

``None`` means the card (``torch.device("cuda")``); asking for CUDA on a
host without it raises at once instead of quietly running on the CPU.
The CPU is used only when the caller names it (``device="cpu"``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def stamp(phases: Dict[str, float], device: torch.device, name: str, t0: float) -> float:
    """Add the wall since ``t0`` to ``phases[name]`` and return now.  On
    a CUDA device it first waits for the card, so a stage's wall covers
    the kernels it queued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    phases[name] = phases.get(name, 0.0) + now - t0
    return now


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
