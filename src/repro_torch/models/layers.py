"""Shared neural-net layers of the language model (plain functions on
tensors; parameters are dicts of tensors, keyed as in the JAX package).

The port of `repro/models/layers.py` for the forward (serving) path.
`rmsnorm` and `mlp_apply` go through `kernels.ops`, so a CUDA tensor runs
the hand-written kernels: the fused kernels are the JAX package's
"inference-path option", which its training path leaves out because
Pallas has no VJP.  `backend` is `ops`' dispatch ("auto", "cuda" or
"plain").  `cross_entropy_chunked` waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

__all__ = ["dense_init", "embed_init", "rmsnorm", "rope_freqs", "apply_rope",
           "mlp_init", "mlp_apply"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) normal * scale (d_in^-0.5 by default), drawn in f32 on
    the generator's device and cast to `dtype`."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype
               ) -> torch.Tensor:
    return dense_init(gen, vocab, d_model, dtype, scale=d_model ** -0.5)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            backend: str = "auto") -> torch.Tensor:
    return ops.rmsnorm(x, w, eps=eps, backend=backend)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos, sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # theta stays a Python number: a tensor made from it on the card would
    # be a host-to-device copy, which waits for the queued work each layer.
    inv = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., S, H, hd) with cos/sin (..., S, hd//2) — rotate-half
    convention, f32 math, cast back."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]   # broadcast over heads
    s = sin[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], -1).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype
             ) -> dict[str, torch.Tensor]:
    return {"wg": dense_init(gen, d_model, d_ff, dtype),
            "wu": dense_init(gen, d_model, d_ff, dtype),
            "wd": dense_init(gen, d_ff, d_model, dtype)}


def mlp_apply(p, x: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    g = x @ p["wg"]
    u = x @ p["wu"]
    return ops.swiglu(g, u, backend=backend) @ p["wd"]
