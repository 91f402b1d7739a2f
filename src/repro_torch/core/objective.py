"""Objectives from the paper.

J(C) = sum_x min_{mu in C} ||x - mu||^2 + lambda^2 |C|        (Eq. 5, DP-means / FL)
BP-means cost = sum_i ||x_i - Z_i F||^2 + lambda^2 K          (MAD-Bayes / BP-means)

Plain products outside any kernel: on the card `torch.matmul` runs in full
f32 as long as `torch.backends.cuda.matmul.allow_tf32` stays False (the
port needs it off; see README).
"""
from __future__ import annotations

import torch

__all__ = ["sq_dists", "dp_means_objective", "bp_means_objective"]


def sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances (N, D) x (K, D) -> (N, K), in
    the expanded form ||x||^2 + ||mu||^2 - 2 x mu^T, clamped at zero."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1)[None, :]
    return torch.clamp_min(x2 + c2 - 2.0 * (x @ centers.T), 0.0)


def dp_means_objective(x: torch.Tensor, centers: torch.Tensor, lam: float,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Facility-location / DP-means objective J(C) (paper Eq. 5)."""
    d2 = sq_dists(x, centers)
    if mask is not None:
        d2 = torch.where(mask[None, :], d2, torch.inf)
        k = torch.sum(mask)
    else:
        k = centers.shape[0]
    return torch.sum(torch.min(d2, dim=-1).values) + lam * lam * k


def bp_means_objective(x: torch.Tensor, z: torch.Tensor, feats: torch.Tensor,
                       lam: float, mask: torch.Tensor | None = None) -> torch.Tensor:
    """BP-means cost: ||X - Z F||_F^2 + lambda^2 K."""
    if mask is not None:
        z = z & mask[None, :]
        k = torch.sum(mask)
    else:
        k = feats.shape[0]
    resid = x - z.to(x.dtype) @ feats
    return torch.sum(resid * resid) + lam * lam * k
