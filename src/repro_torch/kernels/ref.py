"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

Each `<name>_ref` is the semantic spec of a hand-written kernel: the CPU
tests run it, `chip_smoke.py` holds the kernel against it on the card, and
the dispatch in `kernels/ops.py` takes it only for tensors on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["assign_ref", "pairwise_argmin_ref"]


def assign_ref(x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor):
    """`ops.assign` spec: masked min squared distance + argmin, idx = -1
    where no valid center.  Computes IN THE INPUT DTYPE (the expanded-matmul
    algebra of `core.objective.sq_dists`), so routing `nearest_center`
    through it keeps the propose phase's dtype contract."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (x @ centers.T), 0.0)
    d2 = torch.where(mask[None, :], d2, torch.inf)
    d2min, arg = torch.min(d2, dim=-1)
    idx = torch.where(torch.isfinite(d2min), arg, -1).to(torch.int32)
    return d2min, idx


def pairwise_argmin_ref(x: torch.Tensor, centers: torch.Tensor,
                        mask: torch.Tensor | None = None):
    """Min squared distance + argmin over centers, x (N, D), centers (K, D),
    computed in float32 (the kernel's accumulation dtype)."""
    xf = x.to(torch.float32)
    cf = centers.to(torch.float32)
    x2 = torch.sum(xf * xf, dim=-1, keepdim=True)
    c2 = torch.sum(cf * cf, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (xf @ cf.T), 0.0)
    if mask is not None:
        d2 = torch.where(mask[None, :], d2, torch.inf)
    d2min, arg = torch.min(d2, dim=-1)
    return d2min, arg.to(torch.int32)
