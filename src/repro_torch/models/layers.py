"""Shared neural-net layers of the language model (plain functions on
tensors; parameters are dicts of tensors, keyed as in the JAX package).

The port of `repro/models/layers.py`.  `rmsnorm` and `mlp_apply` go
through `kernels.ops`, so a CUDA tensor runs the hand-written kernels on
every path: serving calls the forward kernels, training reaches them and
their backward kernels through `ops`' autograd Functions.  (The JAX
package's training path runs its plain versions, because Pallas has no
VJP.)  `backend` is `ops`' dispatch ("auto", "cuda" or "plain").
`cross_entropy_chunked` is the training loss.

On a mesh (`mp`, a `distributed.shardings.ModelMesh` whose model axis has
more than one rank) `mlp_apply` runs its rank's columns of d_ff (wg, wu
column-split, the swiglu kernel on the rank's columns, wd row-split and the
partial sums all-reduced), `embed` looks up the rank's rows of the
vocabulary (a masked lookup, then the sum), and `cross_entropy_chunked`
takes the logsumexp over the vocabulary's blocks (the max and the sum of
exponentials all-reduced) and the gold logit from the rank that holds it.
Where the axis does not divide d_ff or the vocabulary, the weight is whole
on every rank and the layer runs as on one device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.shardings import (
    copy_to_model, reduce_from_model,
)
from repro_torch.kernels import ops

__all__ = ["dense_init", "embed_init", "rmsnorm", "rope_freqs", "apply_rope",
           "mlp_init", "mlp_apply", "embed", "cross_entropy_chunked"]


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


def mlp_apply(p, x: torch.Tensor, backend: str = "auto",
              mp=None) -> torch.Tensor:
    """SwiGLU MLP; with `mp` (a mesh that splits d_ff: the caller
    decides), `p` holds this rank's columns of wg / wu and rows of wd, and
    the ranks' partial sums are added."""
    x = copy_to_model(x, mp)
    g = x @ p["wg"]
    u = x @ p["wu"]
    return reduce_from_model(ops.swiglu(g, u, backend=backend) @ p["wd"], mp)


def embed(table: torch.Tensor, ids: torch.Tensor, vocab: int,
          mp=None) -> torch.Tensor:
    """table[ids]; on a mesh that splits the vocabulary, `table` holds this
    rank's block of rows: ids outside it give zeros, and the ranks' rows
    are summed (exactly: one rank's is non-zero)."""
    if mp is None or not mp.splits(vocab):
        return table[ids]
    n = table.shape[0]
    local = ids - mp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_model(
        torch.where(inside[..., None], rows, torch.zeros_like(rows)), mp)


# ---------------------------------------------------------------------------
# Sequence-chunked cross entropy: never materializes (B, S, V) logits.
# ---------------------------------------------------------------------------

def _chunk_ce(hx: torch.Tensor, lm_head: torch.Tensor, lx: torch.Tensor
              ) -> torch.Tensor:
    """sum(logsumexp - gold logit) over one chunk, f32 logits."""
    logits = hx.to(torch.float32) @ lm_head.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lx[..., None])[..., 0]
    return torch.sum(lse - gold)


def _chunk_ce_vocab_parallel(hx: torch.Tensor, lm_head: torch.Tensor,
                             lx: torch.Tensor, mp) -> torch.Tensor:
    """`_chunk_ce` with `lm_head` this rank's (D, V/m) block of columns:
    the logsumexp from the max and the sum of exponentials over every
    block (a MAX and a SUM over the model axis) and the gold logit from
    the rank that holds its column."""
    logits = copy_to_model(hx, mp).to(torch.float32) \
        @ lm_head.to(torch.float32)
    mx = mp.all_reduce(logits.detach().amax(-1), dist.ReduceOp.MAX)
    se = reduce_from_model(torch.exp(logits - mx[..., None]).sum(-1), mp)
    n = lm_head.shape[1]
    local = lx - mp.rank * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = reduce_from_model(torch.where(inside, gold,
                                         torch.zeros_like(gold)), mp)
    return torch.sum(mx + torch.log(se) - gold)


def cross_entropy_chunked(h: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor, seq_chunk: int = 512,
                          mp=None) -> torch.Tensor:
    """Mean next-token CE.  h (B, S, D), lm_head (D, V), labels (B, S)
    int64.  One sequence chunk of `seq_chunk` at a time (one chunk when S is
    not a multiple of it), so peak logits memory is (B, chunk, V) f32; the
    backward recomputes each chunk's logits (`torch.utils.checkpoint`).
    Returns a 0-d f32 tensor: the chunks' sums, in order, over B * S.
    f32 matmuls stay IEEE (the caller keeps TF32 off).  With `mp` (a mesh
    that splits the vocabulary), `lm_head` is this rank's (D, V/m) block
    and the loss is the same on every model rank."""
    b, s, _ = h.shape
    c = min(seq_chunk, s)
    if s % c:
        c = s
    fn, extra = (_chunk_ce, ()) if mp is None else \
        (_chunk_ce_vocab_parallel, (mp,))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    record = torch.is_grad_enabled()
    for i in range(s // c):
        hx, lx = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        total = total + (checkpoint(fn, hx, lm_head, lx, *extra,
                                    use_reentrant=False) if record
                         else fn(hx, lm_head, lx, *extra))
    return total / (b * s)
