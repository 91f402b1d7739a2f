"""Carry state between the JAX package and the port, as numpy arrays.

The JAX `CenterPool` / `OCCStats` fields go through `np.asarray` on the JAX
side; these functions take and give the same fields, so a pass run by one
package can be continued by the other from the same pool.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.occ import CenterPool, OCCStats

__all__ = ["pool_from_numpy", "pool_to_numpy", "stats_to_numpy"]


def pool_from_numpy(centers, mask, count, overflow,
                    device: str | torch.device = "cuda") -> CenterPool:
    """The port's `CenterPool` on `device` from the JAX pool's fields:
    centers (K_max, D), mask (K_max,) bool, count () int32, overflow ()
    bool."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=dev)
    centers = np.asarray(centers)
    return CenterPool(t(centers, centers.dtype), t(mask, np.bool_),
                      t(count, np.int32), t(overflow, np.bool_))


def pool_to_numpy(pool: CenterPool) -> dict[str, np.ndarray]:
    """The pool's fields as numpy arrays, keyed by field name."""
    return {k: v.detach().cpu().numpy() for k, v in pool._asdict().items()}


def stats_to_numpy(stats: OCCStats) -> dict[str, np.ndarray | None]:
    """The stats' fields as numpy arrays (cap may be None)."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in stats._asdict().items()}
