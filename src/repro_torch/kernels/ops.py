"""Dispatch between the hand-written kernels and their plain versions.

The device of the input decides, never a probe of the machine:

  backend="auto"   -> a CUDA tensor launches the kernel (or the call raises),
                      a CPU tensor runs the plain version
  backend="cuda"   -> the kernel; raises for a tensor that is not on a card
  backend="plain"  -> the plain version on any device (comparisons only)

There is no fallback: a CUDA tensor reaches the plain version only when
`backend="plain"` is asked for.  Each kernel has a plain-int launch count,
raised by one where the kernel is launched and nowhere else, so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dpmeans_assign import dpmeans_assign as _dpmeans_assign

__all__ = ["assign", "pairwise_argmin", "ASSIGN_LAUNCHES",
           "PAIRWISE_ARGMIN_LAUNCHES", "reset_launch_counts"]

ASSIGN_LAUNCHES = 0
PAIRWISE_ARGMIN_LAUNCHES = 0


def reset_launch_counts() -> None:
    global ASSIGN_LAUNCHES, PAIRWISE_ARGMIN_LAUNCHES
    ASSIGN_LAUNCHES = PAIRWISE_ARGMIN_LAUNCHES = 0


def _use_kernel(x: torch.Tensor, backend: str) -> bool:
    if backend == "plain":
        return False
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if x.device.type == "cuda":
        return True
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got {x.device}")
    return False


def _count_tensor(count, k: int, device) -> torch.Tensor:
    if count is None:
        count = k
    if isinstance(count, torch.Tensor):
        return count.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(count), dtype=torch.int32, device=device)


def assign(x, centers, mask=None, count=None, backend: str = "auto"):
    """Nearest-center assignment: THE OCC propose primitive.

    x (N, D), centers (K, D), mask (K,) bool, count (optional int or
    int32 tensor) bounding the valid prefix.  Returns (d2min (N,), idx (N,)
    int32) with (inf, -1) where no valid center exists.  d2min is f32 from
    the kernel and the input dtype from the plain version, as in the JAX
    package.  The kernel skips center tiles past `count`; the plain version
    folds `count` into the mask, which the pool invariant makes a no-op.
    """
    global ASSIGN_LAUNCHES
    k = centers.shape[0]
    if _use_kernel(x, backend):
        if mask is None:
            mask = torch.ones((k,), dtype=torch.bool, device=x.device)
        out = _dpmeans_assign(x, centers, mask, _count_tensor(count, k, x.device))
        ASSIGN_LAUNCHES += 1
        return out
    if mask is None:
        mask = torch.ones((k,), dtype=torch.bool, device=x.device)
    if count is not None:
        mask = mask & (torch.arange(k, device=x.device) < count)
    return _ref.assign_ref(x, centers, mask)


def pairwise_argmin(x, centers, mask=None, backend: str = "auto"):
    """Kernel/plain pair without the count restriction, for parity tests.
    As in the JAX package the plain version computes in f32 and returns
    argmin 0 (not -1) for a row with no valid center; the kernel returns -1
    there."""
    global PAIRWISE_ARGMIN_LAUNCHES
    k = centers.shape[0]
    if _use_kernel(x, backend):
        if mask is None:
            mask = torch.ones((k,), dtype=torch.bool, device=x.device)
        out = _dpmeans_assign(x, centers, mask, _count_tensor(None, k, x.device))
        PAIRWISE_ARGMIN_LAUNCHES += 1
        return out
    return _ref.pairwise_argmin_ref(x, centers, mask)
