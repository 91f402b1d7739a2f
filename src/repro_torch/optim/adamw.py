"""AdamW and a cosine learning-rate schedule with linear warmup (the port
of `repro/optim/adamw.py`).

Plain functions under `torch.no_grad` on dicts of tensors keyed by the
port's parameter names (`Model.named_parameters()`).  The moments are f32;
each parameter is updated in its own dtype from the f32 update.  Unlike
the JAX package, `adamw_update` writes the parameters and the moments in
place (the JAX train step donates its state), which keeps one copy of the
2.5 B parameters and their moments on the card at full width.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.model import jax_ranks

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor              # () int32
    mu: dict[str, torch.Tensor]     # first moments (f32, keyed as params)
    nu: dict[str, torch.Tensor]     # second moments (f32)


@torch.no_grad()
def adamw_init(params: dict[str, torch.Tensor]) -> AdamWState:
    """Zero moments in f32 and step 0 on the parameters' device."""
    dev = next(iter(params.values())).device
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={n: zeros(p) for n, p in params.items()},
                      nu={n: zeros(p) for n, p in params.items()})


@torch.no_grad()
def cosine_lr(step: torch.Tensor, base_lr: float, warmup: int, total: int,
              min_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), a 0-d f32 tensor on
    its device: linear warmup to base_lr over `warmup` steps, then a cosine
    decay to min_frac * base_lr at `total`.  f32 arithmetic in the JAX
    package's order, except that the cosine of the f32 angle is taken in
    f64 and rounded once (torch's f32 cos is an ulp off at some angles where
    XLA's is not, and 1 + cos near -0.77 doubles that)."""
    step = torch.as_tensor(step)
    f32 = torch.float32
    warm = (step + 1).to(f32) * base_lr / max(warmup, 1)
    prog = torch.clamp((step - warmup).to(f32) / max(total - warmup, 1),
                       0.0, 1.0)
    c = torch.cos((math.pi * prog).to(torch.float64)).to(f32)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + c))
    return torch.where(step < warmup, warm, cos).to(f32)


@torch.no_grad()
def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, f32 (a 0-d tensor)."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32)))
             for g in tree.values())
    return torch.sqrt(sq)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """-> (every gradient scaled in f32 so that their global norm is at most
    max_norm, the norm before scaling).  `training/step.py` passes the scale
    to `adamw_update` instead, which applies it leaf by leaf (the same
    arithmetic, without every f32 gradient at once)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: g.to(torch.float32) * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_scale=None) -> AdamWState:
    """One AdamW step, in place: each parameter, mu and nu is overwritten;
    returns the new state (its step one more).  Moments in f32; each
    parameter updated in its own dtype from the f32 update.  Weight decay
    is decoupled and skipped for the leaves that are 1-D as the JAX package
    lays them out (`models.model.jax_ranks`): there a segment's per-layer
    norms are rows of a stacked (L, D) leaf and decay, and final_norm does
    not.  `grad_scale` (a 0-d tensor), when given, multiplies each f32
    gradient first (the clip of `clip_by_global_norm`, leaf by leaf)."""
    rank = jax_ranks(params)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1t = 1 - b1 ** stepf
    b2t = 1 - b2 ** stepf
    for name, p in params.items():
        gf = grads[name].to(torch.float32)
        if grad_scale is not None:
            gf = gf * grad_scale
        m, v = state.mu[name], state.nu[name]
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        # the square root correctly rounded, as XLA's is (torch's f32 sqrt
        # on the CPU can be an ulp off; on the card sqrtf is exact)
        root = torch.sqrt((v / b2t).to(torch.float64)).to(torch.float32)
        delta = (m / b1t) / (root + eps)
        if rank[name] > 1 and weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return AdamWState(step=step, mu=state.mu, nu=state.nu)
