"""Where the port's entry points run: on the card unless the caller asks
for the CPU.  There is no silent fallback: asking for CUDA on a machine
without a card raises."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (no copy when it is
    already there)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, device=device)
