"""Transformer blocks and layer stacks of the language model.

The port of `repro/models/transformer.py`.  A model body is a list of
segments (`segments_for`, the same layout as the JAX package); a segment
is a list of per-layer parameter dicts run in a Python loop, where the JAX
package stacks them and scans.  The port runs the `attn_mlp` kind (dense
and vision-language families), the `attn_moe` kind (the MoE family:
`models/moe.py` in place of the MLP), the hybrid family's `mamba` blocks
(`models/ssm.py`) and its `shared_attn` block (`attn_mlp`'s layout, one
parameter set for all its uses), and the xLSTM family's `mlstm` and
`slstm` blocks (`models/xlstm.py`); the encoder-decoder's kinds raise
NotImplementedError naming the ROADMAP.md item that ports them.  Every
block norms its input with the rmsnorm kernel; the recurrent blocks'
caches hold state, not keys and values.

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
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm

__all__ = ["SEGMENT_KINDS", "require_ported", "segments_for", "block_shapes",
           "init_block", "block_train", "block_decode", "init_block_cache",
           "run_stack_train", "run_stack_decode"]

# the kinds the port runs
SEGMENT_KINDS = ("attn_mlp", "attn_moe", "shared_attn", "mamba", "mlstm",
                 "slstm")


class _Recurrent(NamedTuple):
    """A recurrent block's functions (its input is normed by norm1)."""
    shapes: Callable      # (cfg, dtype) -> {name: (shape, dtype)}
    init: Callable        # (gen, cfg, dtype) -> {name: tensor}
    train: Callable       # (p, x, cfg) -> (out, state after the sequence)
    decode: Callable      # (p, x, cfg, cache) -> out; the cache in place
    cache: Callable       # (cfg, batch, dtype, device) -> zeroed state


_RECURRENT = {
    "mamba": _Recurrent(ssm_mod.mamba_shapes, ssm_mod.init_mamba,
                        ssm_mod.mamba_train, ssm_mod.mamba_decode,
                        ssm_mod.init_ssm_cache),
    "mlstm": _Recurrent(xlstm_mod.mlstm_shapes, xlstm_mod.init_mlstm,
                        xlstm_mod.mlstm_train, xlstm_mod.mlstm_decode,
                        xlstm_mod.init_mlstm_cache),
    "slstm": _Recurrent(xlstm_mod.slstm_shapes, xlstm_mod.init_slstm,
                        xlstm_mod.slstm_train, xlstm_mod.slstm_decode,
                        xlstm_mod.init_slstm_cache)}

_LATER = {
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
    in `dtype` but the MoE router and Mamba's a_log, dt_bias and d_skip,
    which are f32."""
    require_ported(kind)
    d = cfg.d_model
    if kind in _RECURRENT:
        return {"norm1": ((d,), dtype), **_RECURRENT[kind].shapes(cfg, dtype)}
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
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
    if kind in _RECURRENT:
        return {"norm1": ones(), **_RECURRENT[kind].init(gen, cfg, dtype)}
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
    """-> (x, cache contribution): {"k", "v"} of an attention block, the
    state after the sequence of a recurrent one."""
    require_ported(kind)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, backend)
    if kind in _RECURRENT:
        out, cache = _RECURRENT[kind].train(p, h, cfg)
        return x + out, cache
    a, (k, v) = attn.attention_train(p, h, cfg, positions, backend)
    return _ffn(p, x + a, cfg, backend), {"k": k, "v": v}


def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device) -> dict[str, torch.Tensor]:
    require_ported(kind)
    if kind in _RECURRENT:
        return _RECURRENT[kind].cache(cfg, batch, dtype, device)
    return attn.init_kv_cache(cfg, batch, cache_len, dtype, device)


def block_decode(p, x, cfg, kind: str, cache, pos, decode_mode: str = "tp",
                 backend: str = "auto"):
    require_ported(kind)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, backend)
    if kind in _RECURRENT:
        return x + _RECURRENT[kind].decode(p, h, cfg, cache), cache
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
