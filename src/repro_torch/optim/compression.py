"""Int8 gradient compression with error feedback (the port of
`repro/optim/compression.py`).

int8 quantization cuts the bytes of a cross-pod gradient reduce 4x (vs
f32); error feedback (residual accumulation) makes the quantization bias
telescope to zero (Karimireddy et al., 2019).  One card has no cross-pod
reduce: `apply_error_feedback` is the single-process form the JAX train
step runs.  `compressed_psum_with_feedback` is the collective form: the
body each rank runs, over the group of one axis of the current sharding
context's mesh (the JAX package's shard_map body).

Gradients are dicts keyed by the port's parameter names.  The JAX package
quantizes each leaf of its tree with one scale, and a segment's leaf
stacks every layer's tensor; `groups` (name -> group key) gives the
tensors that share a scale, so the port quantizes exactly as the
reference does.  The collective form takes one scale a tensor, as the
JAX package's does.  The sharded train step, as the JAX package's, runs
`apply_error_feedback` on the logical gradients: each rank its blocks,
with each group's amax taken over the whole leaf (`amax_reduce`).
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
                         groups: dict[str, str] | None = None,
                         amax_reduce=None):
    """Add the residual, quantize / dequantize with one scale per group (per
    tensor when `groups` is None), keep the new residual.  Returns
    (dequantized f32 grads, new EFState).  On a mesh each rank passes its
    blocks and `amax_reduce`, which takes the stacked (groups,) amax of its
    blocks to the amax over the whole leaves (an all-reduce MAX), so every
    block quantizes with its whole leaf's scale."""
    corrected = {n: g.to(torch.float32) + ef.residual[n]
                 for n, g in grads.items()}
    amax: dict[str, torch.Tensor] = {}
    for n, c in corrected.items():
        key = n if groups is None else groups[n]
        m = torch.max(torch.abs(c))
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    if amax_reduce is not None:
        whole = amax_reduce(torch.stack(list(amax.values())))
        amax = dict(zip(amax, whole.unbind()))
    out, residual = {}, {}
    for n, c in corrected.items():
        scale = _scale(amax[n if groups is None else groups[n]])
        out[n] = decompress_int8(_quantize(c, scale), scale)
        residual[n] = c - out[n]
    return out, EFState(residual)


@torch.no_grad()
def compressed_psum_with_feedback(grads: dict[str, torch.Tensor], ef: EFState,
                                  axis: str):
    """int8-compressed sum over the ranks of mesh axis `axis`
    (`shardings.current_ctx().mesh`) with error feedback; every rank calls
    it with its own grads.  One scale a tensor, shared across the axis (an
    all-reduce MAX of the tensors' amax), so the int8 codes, summed as
    int32 by an all-reduce SUM, add exactly and every rank dequantizes
    alike; each rank's quantization error goes into its residual.  The
    reference's order of operations; two collectives in all, whatever the
    number of tensors.  Returns (summed f32 grads, new EFState)."""
    import torch.distributed as dist
    from repro_torch.distributed.shardings import current_ctx
    group = current_ctx().mesh.get_group(axis)
    corrected = {n: g.to(torch.float32) + ef.residual[n]
                 for n, g in grads.items()}
    amax = torch.stack([torch.max(torch.abs(c)) for c in corrected.values()])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = {n: _scale(amax[i]) for i, n in enumerate(corrected)}
    q = {n: _quantize(c, scale[n]) for n, c in corrected.items()}
    residual = {n: c - q[n].to(torch.float32) * scale[n]
                for n, c in corrected.items()}
    flat = torch.cat([q[n].to(torch.int32).reshape(-1) for n in corrected])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = {}, 0
    for n, c in corrected.items():
        qsum = flat[at:at + c.numel()].reshape(c.shape)
        at += c.numel()
        out[n] = qsum.to(torch.float32) * scale[n]
    return out, EFState(residual)
