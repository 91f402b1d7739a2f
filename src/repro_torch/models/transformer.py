"""Transformer blocks and layer stacks of the language model.

The port of `repro/models/transformer.py`.  A model body is a list of
segments (`segments_for`, the same layout as the JAX package); a segment
is a list of per-layer parameter dicts run in a Python loop, where the JAX
package stacks them and scans.  The port runs the `attn_mlp` kind (dense
and vision-language families), the `attn_moe` kind (the MoE family:
`models/moe.py` in place of the MLP), the hybrid family's `mamba` blocks
(`models/ssm.py`) and its `shared_attn` block (`attn_mlp`'s layout, one
parameter set for all its uses), the xLSTM family's `mlstm` and `slstm`
blocks (`models/xlstm.py`), and the encoder-decoder's `enc_attn_mlp`
(`attn_mlp`'s layout; bidirectional attention, a full softmax in plain
torch, as in the JAX package) and `dec_attn_mlp` (causal self-attention,
then cross-attention over the encoder's output, then the MLP; its cache
adds the static cross keys and values "ck", "cv").  Every block norms its
input with the rmsnorm kernel; the recurrent blocks' caches hold state,
not keys and values.

On a mesh (`mp`, a `distributed.shardings.ModelMesh`) the blocks run this
rank's part: its heads (`models/attention.py`), its columns of d_ff
(`models/layers.mlp_apply`), its experts (`models/moe.py`) and its Mamba2
heads (`models/ssm.py`).  The `attn_mlp`, `attn_moe`, `mamba` and
`shared_attn` kinds run on a model axis of more than one rank
(`require_mesh_ported`; the shared block splits as `attn_mlp` does, and
its one parameter set gathers the gradient of every use); every kind runs
on the data axes, whose parameters `run_stack_*` gather before a block
runs (`local_weights`).

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

from repro_torch.distributed.shardings import is_dtensor, unshard
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import mlp_apply, mlp_init, rmsnorm

__all__ = ["SEGMENT_KINDS", "require_ported", "require_mesh_ported",
           "segments_for", "block_shapes", "init_block", "block_train",
           "block_decode", "init_block_cache", "run_stack_train",
           "run_stack_decode", "local_weights"]

# the kinds the port runs
SEGMENT_KINDS = ("attn_mlp", "attn_moe", "shared_attn", "mamba", "mlstm",
                 "slstm", "enc_attn_mlp", "dec_attn_mlp")


class _Recurrent(NamedTuple):
    """A recurrent block's functions (its input is normed by norm1); those
    of a kind in MESH_KINDS also take the mesh as `mp=`."""
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

def require_ported(kind: str) -> None:
    if kind not in SEGMENT_KINDS:
        raise ValueError(kind)


# the kinds that run on a model axis of more than one rank
MESH_KINDS = ("attn_mlp", "attn_moe", "mamba", "shared_attn")


def _mesh_kw(kind: str, mp) -> dict:
    """The mesh argument of a recurrent kind's functions: `mp=` for a kind
    that runs on a model axis, none for the others (which the model axis
    refuses, `require_mesh_ported`)."""
    return {"mp": mp} if kind in MESH_KINDS else {}


def require_mesh_ported(cfg, mp) -> None:
    """Raise for what the language model's mesh does not run: a kind
    outside MESH_KINDS (`mlstm`, `slstm`, `enc_attn_mlp`, `dec_attn_mlp`),
    or a frontend, on a model axis of more than one rank, and the dry
    run's levers (`seq_shard_acts`, `force_decode_mode`)."""
    if mp is None:
        return
    what = []
    if mp.ctx.seq_shard_acts:
        what.append("seq_shard_acts")
    if mp.ctx.force_decode_mode is not None:
        what.append("force_decode_mode")
    if mp.size > 1:
        what += sorted({k for k, _, _ in segments_for(cfg)
                        if k not in MESH_KINDS})
        if cfg.frontend or cfg.is_encdec:
            what.append(f"the {cfg.frontend} frontend")
    if what:
        raise NotImplementedError(
            f"{', '.join(what)} on this mesh: queued after the dense, MoE "
            "and hybrid families' tensor parallelism (ROADMAP.md queue 1: "
            "multi-card)")


def local_weights(p, mp=None) -> dict:
    """A block's (or any) parameter dict as the tensors a forward runs on:
    a DTensor (a model's own parameter on a mesh) gathered over the data
    axes (ZeRO-3) into this rank's tensor-parallel block; a plain tensor
    (one device, or the train step's gathered leaves) as it is."""
    return {name: unshard(p[name], mp.data_axes) if is_dtensor(p[name])
            else p[name] for name in p.keys()}


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
    if kind == "dec_attn_mlp":
        shapes.update(norm_x=(d,), cross_wq=(d, h * hd),
                      cross_wk=(d, hkv * hd), cross_wv=(d, hkv * hd),
                      cross_wo=(h * hd, d))
    if kind == "attn_moe":
        shapes["norm2"] = (d,)
    elif cfg.d_ff:
        shapes.update(norm2=(d,), wg=(d, cfg.d_ff), wu=(d, cfg.d_ff),
                      wd=(cfg.d_ff, d))
    out = {n: (s, dtype) for n, s in shapes.items()}
    if kind == "attn_moe":
        out.update(moe_mod.moe_shapes(cfg, dtype))
    return out


def init_block(gen: torch.Generator, cfg, kind: str, dtype):
    """-> (name, tensor) pairs of one block, drawn from `gen` in the JAX
    package's order, each only when asked for (the model keeps one before
    the next is drawn: an expert leaf of phi3.5-moe is 1.68 GB in f32)."""
    require_ported(kind)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype,   # noqa: E731
                              device=gen.device)
    yield "norm1", ones()
    if kind in _RECURRENT:
        yield from _RECURRENT[kind].init(gen, cfg, dtype).items()
        return
    yield from attn.init_attention(gen, cfg, dtype).items()
    if kind == "dec_attn_mlp":
        yield "norm_x", ones()
        yield from attn.init_attention(gen, cfg, dtype, cross=True).items()
    if kind == "attn_moe":
        yield "norm2", ones()
        yield from moe_mod.init_moe(gen, cfg, dtype)
    elif cfg.d_ff:
        yield "norm2", ones()
        yield from mlp_init(gen, cfg.d_model, cfg.d_ff, dtype).items()


def _ffn(p, x, cfg, backend, mp=None):
    """The block's second half: x + MLP or MoE of rmsnorm(x, norm2)."""
    if "wg" in p:
        return x + mlp_apply(p, rmsnorm(x, p["norm2"], cfg.norm_eps,
                                        backend), backend,
                             mp if mp is not None and mp.splits(cfg.d_ff)
                             else None)
    if "router" in p:
        return x + moe_mod.moe_apply(
            p, rmsnorm(x, p["norm2"], cfg.norm_eps, backend), cfg, backend,
            mp if mp is not None and mp.splits(cfg.moe.n_experts) else None)
    return x


def block_train(p, x, cfg, kind: str, positions, backend: str = "auto",
                cross_kv=None, mp=None):
    """-> (x, cache contribution): {"k", "v"} of an attention block (and
    the cross keys and values "ck", "cv" of a decoder block), the state
    after the sequence of a recurrent one.  For `dec_attn_mlp`, `cross_kv`
    is the encoder's output (B, F, D), which the block projects with its
    own cross-attention weights."""
    require_ported(kind)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, backend)
    if kind in _RECURRENT:
        out, cache = _RECURRENT[kind].train(p, h, cfg, **_mesh_kw(kind, mp))
        return x + out, cache
    if kind == "enc_attn_mlp":
        a, (k, v) = _bidir_attention(p, h, cfg, positions)
    else:
        a, (k, v) = attn.attention_train(p, h, cfg, positions, backend, mp)
    x = x + a
    cache = {"k": k, "v": v}
    if kind == "dec_attn_mlp":
        ckv = attn.encode_kv(p, cross_kv, cfg)
        hx = rmsnorm(x, p["norm_x"], cfg.norm_eps, backend)
        x = x + attn.cross_attention(p, hx, cfg, ckv)
        cache["ck"], cache["cv"] = ckv["k"], ckv["v"]
    return _ffn(p, x, cfg, backend, mp), cache


def _bidir_attention(p, h, cfg, positions):
    """The encoder's self-attention: no causal mask, one softmax over every
    position (no chunks; plain torch, never the flash kernel, as in the JAX
    package).  -> (out (B, S, D), (k, v))."""
    b, s, _ = h.shape
    q, k, v = attn._project_qkv(p, h, cfg, positions)
    w = torch.softmax(attn._gqa_logits(q, k, cfg.hd ** -0.5), dim=-1)
    o = attn._gqa_out(w, v).to(h.dtype)
    return o.reshape(b, s, -1) @ p["wo"], (k, v)


def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype,
                     device, enc_len: int = 0, mp=None,
                     mode: str = "tp") -> dict[str, torch.Tensor]:
    """A layer's zeroed cache; a decoder block's cross keys and values
    (batch, enc_len or cfg.frontend_len, Hkv, hd) beside its own.  On a
    mesh, this rank's block in decode mode `mode`'s layout
    (`attention.init_kv_cache`; a Mamba block's state is head-split in
    either mode, `ssm.init_ssm_cache`)."""
    require_ported(kind)
    if kind in _RECURRENT:
        return _RECURRENT[kind].cache(cfg, batch, dtype, device,
                                      **_mesh_kw(kind, mp))
    c = attn.init_kv_cache(cfg, batch, cache_len, dtype, device, mp, mode)
    if kind == "dec_attn_mlp":
        cc = attn.init_kv_cache(cfg, batch, enc_len or cfg.frontend_len,
                                dtype, device)
        c["ck"], c["cv"] = cc["k"], cc["v"]
    return c


def block_decode(p, x, cfg, kind: str, cache, pos, decode_mode: str = "tp",
                 backend: str = "auto", mp=None):
    require_ported(kind)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps, backend)
    if kind in _RECURRENT:
        return x + _RECURRENT[kind].decode(p, h, cfg, cache,
                                           **_mesh_kw(kind, mp)), cache
    a, _ = attn.attention_decode(p, h, cfg, cache, pos, mode=decode_mode,
                                 mp=mp)
    x = x + a
    if kind == "dec_attn_mlp":
        # the static cross keys and values of the prefill (or init_cache)
        hx = rmsnorm(x, p["norm_x"], cfg.norm_eps, backend)
        x = x + attn.cross_attention(p, hx, cfg,
                                     {"k": cache["ck"], "v": cache["cv"]})
    return _ffn(p, x, cfg, backend, mp), cache


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
                    want_cache: bool = False, backend: str = "auto",
                    cross_kv=None, mp=None):
    """Run the blocks of one segment in order, each rematerialized as
    `cfg.remat` says; -> (x, [per-layer cache] or None).  `cross_kv`: the
    encoder's output, for a decoder segment.  `mp`: the mesh, if any."""
    block = _remat_wrap(block_train, cfg)
    caches = []
    for p in layers:
        # the layer's tensors as they are now (a recompute in the backward
        # must see the ones the forward saw: under torch.func.functional_call
        # the module's own attributes are restored by then)
        p = local_weights(p, mp)
        x, cache = block(p, x, cfg, kind, positions, backend, cross_kv, mp)
        if want_cache:
            caches.append(cache)
    return x, (caches if want_cache else None)


def run_stack_decode(layers, x, cfg, kind: str, caches, pos,
                     decode_mode: str = "tp", backend: str = "auto",
                     mp=None):
    """One decode step through the blocks of one segment; the per-layer
    caches are written in place and returned."""
    for p, cache in zip(layers, caches):
        x, _ = block_decode(local_weights(p, mp), x, cfg, kind, cache, pos,
                            decode_mode, backend, mp)
    return x, caches
