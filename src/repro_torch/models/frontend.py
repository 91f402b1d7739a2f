"""The modality frontends' projector (the port of
`repro/models/frontend.py`).

As in the JAX package, the vision and audio encoders themselves are out of
scope: a batch carries precomputed patch or frame embeddings (B, F,
frontend_dim) under "frontend", and this projector maps them into the
backbone's width.  Plain torch on every device, as it is plain jnp there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

__all__ = ["frontend_shapes", "init_frontend", "frontend_project"]


def frontend_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Parameter names and shapes of the projector ({} without a
    frontend)."""
    if not cfg.frontend:
        return {}
    d = cfg.d_model
    return {"fe_w1": (cfg.frontend_dim, d), "fe_w2": (d, d), "fe_norm": (d,)}


def init_frontend(gen: torch.Generator, cfg, dtype
                  ) -> dict[str, torch.Tensor]:
    if not cfg.frontend:
        return {}
    d = cfg.d_model
    return {"fe_w1": dense_init(gen, cfg.frontend_dim, d, dtype),
            "fe_w2": dense_init(gen, d, d, dtype),
            "fe_norm": torch.ones((d,), dtype=dtype, device=gen.device)}


def frontend_project(p, embeds: torch.Tensor, cfg) -> torch.Tensor:
    """embeds (B, F, frontend_dim) -> (B, F, d_model): `fe_w1`, GELU in f32
    cast back, `fe_w2`.  The GELU is the tanh form, `jax.nn.gelu`'s
    default (torch's default, the erf form, differs by about 4e-4)."""
    h = embeds.to(p["fe_w1"].dtype) @ p["fe_w1"]
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(h.dtype)
    return h @ p["fe_w2"]
