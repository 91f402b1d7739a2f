"""Transformer blocks and layer stacks of the language model.

The port of `repro/models/transformer.py`.  A model body is a list of
segments (`segments_for`, the same layout as the JAX package); a segment
is a list of per-layer parameter dicts run in a Python loop, where the JAX
package stacks them and scans.  The port runs the `attn_mlp` kind (dense
and vision-language families) and the `attn_moe` kind (the MoE family:
`models/moe.py` in place of the MLP); the other kinds raise
NotImplementedError naming the ROADMAP.md item that ports them.

Where autograd records, `run_stack_train` rematerializes each block as
`cfg.remat` says (the counterpart of the JAX package's `_remat_wrap`):
"full" checkpoints the block (its backward reruns the forward from the
block's input), "dots" checkpoints it selectively, keeping the outputs of
its matrix products (`aten.mm`, the projections; the attention's batched
products are recomputed, as `dots_with_no_batch_dims_saveable` does), and
"none" keeps every activation.  Remat changes no bit of the loss or the
gradients.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm

__all__ = ["SEGMENT_KINDS", "require_ported", "segments_for", "block_shapes",
           "init_block", "block_train", "block_decode", "init_block_cache",
           "run_stack_train", "run_stack_decode"]

SEGMENT_KINDS = ("attn_mlp", "attn_moe")   # the kinds the port runs

_LATER = {
    "mamba": "ROADMAP.md queue 1: hybrid/ssm",
    "shared_attn": "ROADMAP.md queue 1: hybrid/ssm",
    "mlstm": "ROADMAP.md queue 1: xlstm",
    "slstm": "ROADMAP.md queue 1: xlstm",
    "dec_attn_mlp": "ROADMAP.md queue 1: frontends and the encoder-decoder",
    "enc_attn_mlp": "ROADMAP.md queue 1: frontends and the encoder-decoder",
}


def require_ported(kind: str) -> None:
    if kind in SEGMENT_KINDS:
        return
    if kind in _LATER:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                  f"({_LATER[kind]})")
    raise ValueError(kind)


def segments_for(cfg) -> list[tuple[str, int, bool]]:
    """-> [(kind, count, shared_params)] executed in order."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return [("attn_mlp", cfg.n_layers, False)]
    if fam in ("moe",):
        return [("attn_moe", cfg.n_layers, False)]
    if fam == "hybrid":
        segs: list[tuple[str, int, bool]] = []
        k = cfg.attn_every
        full, rem = divmod(cfg.n_layers, k)
        for _ in range(full):
            segs.append(("mamba", k, False))
            segs.append(("shared_attn", 1, True))
        if rem:
            segs.append(("mamba", rem, False))
        return segs
    if fam == "ssm" and cfg.slstm_every:
        segs = []
        k = cfg.slstm_every
        full, rem = divmod(cfg.n_layers, k)
        for _ in range(full):
            if k > 1:
                segs.append(("mlstm", k - 1, False))
            segs.append(("slstm", 1, False))
        if rem:
            segs.append(("mlstm", rem, False))
        return segs
    if fam == "ssm":
        return [("mamba", cfg.n_layers, False)]
    if fam == "audio":
        return [("dec_attn_mlp", cfg.n_layers, False)]
    raise ValueError(f"unknown family {fam}")


def block_shapes(cfg, kind: str, dtype
                 ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Parameter names, shapes and dtypes of one block, as `init_block`
    makes them (the model allocates from this before filling): every tensor
    in `dtype` but the MoE router, which is f32."""
    require_ported(kind)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"norm1": (d,), "wq": (d, h * hd), "wk": (d, hkv * hd),
              "wv": (d, hkv * hd), "wo": (h * hd, d)}
    if cfg.qk_norm:
        shapes["qn"] = shapes["kn"] = (hd,)
    if kind == "attn_moe":
        shapes["norm2"] = (d,)
    elif cfg.d_ff:
        shapes.update(norm2=(d,), wg=(d, cfg.d_ff), wu=(d, cfg.d_ff),
                      wd=(cfg.d_ff, d))
    out = {n: (s, dtype) for n, s in shapes.items()}
    if kind == "attn_moe":
        out.update(moe_mod.moe_shapes(cfg, dtype))
    return out


def init_block(gen: torch.Generator, cfg, kind: str, dtype
               ) -> dict[str, torch.Tensor]:
    require_ported(kind)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype,   # noqa: E731
                              device=gen.device)
    p = {"norm1": ones(), **attn.init_attention(gen, cfg, dtype)}
    if kind == "attn_moe":
        p["norm2"] = ones()
        p.update(moe_mod.init_moe(gen, cfg, dtype))
    elif cfg.d_ff:
        p["norm2"] = ones()
        p.update(mlp_init(gen, cfg.d_model, cfg.d_ff, dtype))
    return p


def _ffn(p, x, cfg, backend):
    """The block's second half: x + MLP or MoE of rmsnorm(x, norm2)."""
    if "wg" in p:
        return x + mlp_apply(p, rmsnorm(x, p["norm2"], cfg.norm_eps,
                                        backend), backend)
    if "router" in p:
        return x + moe_mod.moe_apply(
            p, rmsnorm(x, p["norm2"], cfg.norm_eps, backend), cfg, backend)
    return x


def block_train(p, x, cfg, kind: str, positions, backend: str = "auto"):
    """-> (x, {"k", "v"}): the prefill cache contribution of the block."""
    require_ported(kind)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, backend)
    a, (k, v) = attn.attention_train(p, h, cfg, positions, backend)
    return _ffn(p, x + a, cfg, backend), {"k": k, "v": v}


def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device) -> dict[str, torch.Tensor]:
    require_ported(kind)
    return attn.init_kv_cache(cfg, batch, cache_len, dtype, device)


def block_decode(p, x, cfg, kind: str, cache, pos, decode_mode: str = "tp",
                 backend: str = "auto"):
    require_ported(kind)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, backend)
    a, cache = attn.attention_decode(p, h, cfg, cache, pos, mode=decode_mode)
    return _ffn(p, x + a, cfg, backend), cache


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the matrix products without batch dims."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg):
    """fn as `cfg.remat` rematerializes it where autograd records."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def run_stack_train(layers, x, cfg, kind: str, positions,
                    want_cache: bool = False, backend: str = "auto"):
    """Run the blocks of one segment in order, each rematerialized as
    `cfg.remat` says; -> (x, [per-layer cache] or None)."""
    block = _remat_wrap(block_train, cfg)
    caches = []
    for p in layers:
        # the layer's tensors as they are now (a recompute in the backward
        # must see the ones the forward saw: under torch.func.functional_call
        # the module's own attributes are restored by then)
        p = {name: p[name] for name in p.keys()}
        x, cache = block(p, x, cfg, kind, positions, backend)
        if want_cache:
            caches.append(cache)
    return x, (caches if want_cache else None)


def run_stack_decode(layers, x, cfg, kind: str, caches, pos,
                     decode_mode: str = "tp", backend: str = "auto"):
    """One decode step through the blocks of one segment; the per-layer
    caches are written in place and returned."""
    for p, cache in zip(layers, caches):
        x, _ = block_decode(p, x, cfg, kind, cache, pos, decode_mode,
                            backend)
    return x, caches
