"""Int8 gradient compression with error feedback (the port of
`repro/optim/compression.py`).

int8 quantization cuts the bytes of a cross-pod gradient reduce 4x (vs
f32); error feedback (residual accumulation) makes the quantization bias
telescope to zero (Karimireddy et al., 2019).  One card has no cross-pod
reduce: `apply_error_feedback` is the single-process form the JAX train
step runs.  The collective form waits for the multi-card slice.

Gradients are dicts keyed by the port's parameter names.  The JAX package
quantizes each leaf of its tree with one scale, and a segment's leaf
stacks every layer's tensor; `groups` (name -> group key) gives the
tensors that share a scale, so the port quantizes exactly as the
reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["compress_int8", "decompress_int8", "EFState", "ef_init",
           "compressed_psum_with_feedback", "apply_error_feedback"]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round, like jnp.round, rounds half to even
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


@torch.no_grad()
def compress_int8(x: torch.Tensor):
    """-> (q int8, scale f32 ()) with symmetric per-tensor scaling."""
    xf = x.to(torch.float32)
    scale = _scale(torch.max(torch.abs(xf)))
    return _quantize(xf, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class EFState(NamedTuple):
    residual: dict[str, torch.Tensor]   # error-feedback memory (f32)


@torch.no_grad()
def ef_init(grads: dict[str, torch.Tensor]) -> EFState:
    return EFState({n: torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device)
                    for n, g in grads.items()})


@torch.no_grad()
def apply_error_feedback(grads: dict[str, torch.Tensor], ef: EFState,
                         groups: dict[str, str] | None = None):
    """Add the residual, quantize / dequantize with one scale per group (per
    tensor when `groups` is None), keep the new residual.  Returns
    (dequantized f32 grads, new EFState)."""
    corrected = {n: g.to(torch.float32) + ef.residual[n]
                 for n, g in grads.items()}
    amax: dict[str, torch.Tensor] = {}
    for n, c in corrected.items():
        key = n if groups is None else groups[n]
        m = torch.max(torch.abs(c))
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    out, residual = {}, {}
    for n, c in corrected.items():
        scale = _scale(amax[n if groups is None else groups[n]])
        out[n] = decompress_int8(_quantize(c, scale), scale)
        residual[n] = c - out[n]
    return out, EFState(residual)


def compressed_psum_with_feedback(grads, ef: EFState, axis: str):
    """The int8-compressed cross-pod psum with error feedback needs a
    collective over several cards."""
    raise NotImplementedError(
        "compressed_psum_with_feedback is a collective over several cards: "
        "it waits for the multi-card slice (ROADMAP.md queue 1: multi-card)")
