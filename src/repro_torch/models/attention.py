"""GQA attention of the language model: training and prefill (chunked, or
the flash kernel), one-token decode over a slot KV cache, and the
encoder-decoder's cross-attention.

The port of `repro/models/attention.py` for one card.  `attention_train`
routes to `ops.flash_attention` when `cfg.attn_impl == "flash"` and the
activations are on a CUDA device, the counterpart of the JAX package's
`ops.on_tpu()` test; otherwise it runs the chunked attention, as the JAX
package does off the TPU.  Decode attention stays plain torch, as it is
plain jnp in the JAX package.  Cross-attention (`encode_kv` once over the
encoder's output, then `cross_attention`: no causal mask, no RoPE) is
plain torch, f32 logits and softmax, as it is plain jnp in the JAX
package.  Training runs the chunked attention, as the JAX package does (its
flash kernel has no VJP, nor has the port's: `ops.flash_attention` refuses
a tensor that needs a gradient); unless `cfg.remat` is "none", the
backward recomputes each query chunk's logits.

On a mesh (`mp`, a `distributed.shardings.ModelMesh`) the heads split over
the model axis when it divides n_heads (`_HeadPlan`): q / k / v are
column-split (this rank's heads), `wo` row-split, and the ranks' partial
outputs summed (`reduce_from_model`); the flash kernel runs on the rank's
H/m heads.  Where the axis does not divide n_kv_heads, k and v are whole on
every rank and each rank's q heads attend their own kv heads (h // group).
Where it does not divide n_heads, every rank runs the whole attention.
Decode mode "tp" keeps the cache split on kv heads when the axis divides
them (else whole); mode "cp" (context-parallel, `_cp_decode`) splits it on
the sequence over the model axis: the owning rank writes the new key and
value, every rank forms the partial (max, sum, weighted V) over its slots
for every head, and an all-reduce MAX and one SUM combine them.  "cp"
runs as "tp" without a mesh or a model axis, as in the JAX package; where
the axis does not divide the cache length, the JAX package's fallback is
`Model.decode_layout`'s (the serving engine's), and `init_kv_cache`
refuses a "cp" cache.

Unlike the JAX package, `attention_decode` writes the new key and value
into the cache tensors in place (and returns the same dict).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.shardings import (
    copy_to_model, model_whole, reduce_from_model,
)
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import apply_rope, dense_init, rope_freqs

__all__ = ["init_attention", "attention_train", "attention_decode",
           "init_kv_cache", "cross_attention", "encode_kv"]

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype, cross: bool = False
                   ) -> dict[str, torch.Tensor]:
    """wq, wk, wv, wo (and qn, kn with qk_norm); with `cross`, the
    cross-attention's cross_wq ... cross_wo, never normed."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pre = "cross_" if cross else ""
    p = {pre + "wq": dense_init(gen, d, h * hd, dtype),
         pre + "wk": dense_init(gen, d, hkv * hd, dtype),
         pre + "wv": dense_init(gen, d, hkv * hd, dtype),
         pre + "wo": dense_init(gen, h * hd, d, dtype,
                                scale=(h * hd) ** -0.5)}
    if cfg.qk_norm and not cross:
        p["qn"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["kn"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _qk_norm(x, w, eps):
    # Plain torch on every device, as in the JAX package (no kernel).
    return ref.rmsnorm_ref(x, w, eps)


class _HeadPlan(NamedTuple):
    """A rank's heads on a mesh: q heads [q0, q0 + hq), or every head where
    the model axis does not divide n_heads (`split` false); k / v on the
    rank's kv heads where it divides n_kv_heads (`kv_split`), else whole,
    and then `kv_idx`, the kv heads its q heads attend in order (each kv
    head once where the rank's q heads fall in whole groups of it)."""
    split: bool
    q0: int
    hq: int
    kv_split: bool
    kv_idx: tuple | None


def head_plan(cfg, mp) -> _HeadPlan | None:
    """None without a model axis (one device's attention)."""
    if mp is None or mp.size == 1:
        return None
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    if not mp.splits(h):
        return _HeadPlan(False, 0, h, False, None)
    hq = h // mp.size
    q0 = mp.rank * hq
    if mp.splits(hkv):
        return _HeadPlan(True, q0, hq, True, None)
    g = h // hkv
    idx = [(q0 + i) // g for i in range(hq)]
    uniq = sorted(set(idx))
    per = hq // len(uniq)
    if hq % len(uniq) == 0 and idx == [uniq[i // per] for i in range(hq)]:
        idx = uniq
    return _HeadPlan(True, q0, hq, False, tuple(idx))


def _kv_heads(t, plan):
    """The kv heads (dim 2) this rank's q heads attend."""
    if plan is None or plan.kv_idx is None:
        return t
    return t[:, :, list(plan.kv_idx)]


def _project_qkv(p, x, cfg, positions, plan=None, mp=None):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,Hkv,hd), qk-normed + roped.  On
    a mesh (`plan`), q holds this rank's heads and k, v its kv heads (or
    every kv head where they are whole); where every rank runs every head,
    the weights are gathered whole."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    qn, kn = p.get("qn"), p.get("kn")
    if plan is not None:
        part = plan.split    # each rank's graph a part of the whole
        if part:
            x = copy_to_model(x, mp)
        else:
            wq = model_whole(wq, 1, h * hd, mp, False)
        if not plan.kv_split:
            wk = model_whole(wk, 1, hkv * hd, mp, part)
            wv = model_whole(wv, 1, hkv * hd, mp, part)
        if cfg.qk_norm and part:
            qn, kn = copy_to_model(qn, mp), copy_to_model(kn, mp)
    q = (x @ wq).reshape(b, s, -1, hd)
    k = (x @ wk).reshape(b, s, -1, hd)
    v = (x @ wv).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, qn, cfg.norm_eps)
        k = _qk_norm(k, kn, cfg.norm_eps)
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out(p, o, cfg, plan, mp):
    """o (B,c,H or this rank's heads,hd) through wo -> (B,c,D): row-split
    and summed over the model ranks where the heads split; wo gathered
    whole where every rank runs every head."""
    b, c = o.shape[:2]
    wo = p["wo"]
    if plan is not None and not plan.split:
        wo = model_whole(wo, 0, cfg.n_heads * cfg.hd, mp, False)
    out = o.reshape(b, c, -1) @ wo
    return reduce_from_model(out, mp) if plan is not None and plan.split \
        else out


def _gqa_logits(q, k, scale):
    """q (B,c,H,hd), k (B,S,Hkv,hd) -> logits (B,Hkv,g,c,S) in f32."""
    b, c, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, c, hkv, h // hkv, hd)
    return torch.einsum("bchgd,bshd->bhgcs", qg.to(torch.float32),
                        k.to(torch.float32)) * scale


def _gqa_out(w, v):
    """w (B,Hkv,g,c,S), v (B,S,Hkv,hd) -> (B,c,H,hd) f32."""
    b, hkv, g, c, s = w.shape
    out = torch.einsum("bhgcs,bshd->bchgd", w, v.to(torch.float32))
    return out.reshape(b, c, hkv * g, -1)


def _chunk_attention(qc, k, v, q0: int, scale: float):
    """One query chunk qc (B, c, H, hd) starting at position q0 against
    every key: masked softmax, (B, c, H, hd) f32."""
    c = qc.shape[1]
    logits = _gqa_logits(qc, k, scale)
    k_pos = torch.arange(k.shape[1], device=qc.device)
    q_pos = q0 + torch.arange(c, device=qc.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    logits = torch.where(mask, logits, NEG_INF)
    return _gqa_out(torch.softmax(logits, dim=-1), v)


def _chunked_causal_attention(q, k, v, cfg, q_offset: int = 0):
    """Memory-bounded causal attention, one query chunk at a time: peak
    logits are (B, Hkv, g, chunk, S) f32 instead of (.., S, S).  Where
    autograd records and cfg.remat is not "none", each chunk is
    checkpointed: its backward recomputes its logits instead of keeping
    (chunk, S) softmax weights for every chunk (flash-style)."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    c = min(cfg.attn_chunk, s)
    if s % c:
        c = s
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    outs = []
    for i in range(s // c):
        args = (q[:, i * c:(i + 1) * c], k, v, q_offset + i * c, scale)
        outs.append(checkpoint(_chunk_attention, *args, use_reentrant=False)
                    if remat else _chunk_attention(*args))
    return torch.cat(outs, 1).to(q.dtype)


def attention_train(p, x, cfg, positions, backend: str = "auto", mp=None):
    """Full-sequence causal self-attention (training and prefill).

    Returns (out (B,S,D), (k, v)), the (B,S,Hkv,hd) prefill cache
    contribution (on a mesh, this rank's kv heads, or all where they are
    whole: the "tp" cache layout).
    """
    plan = head_plan(cfg, mp)
    q, k, v = _project_qkv(p, x, cfg, positions, plan, mp)
    ka, va = _kv_heads(k, plan), _kv_heads(v, plan)
    if cfg.attn_impl == "flash" and x.device.type == "cuda":
        o = ops.flash_attention(q.transpose(1, 2), ka.transpose(1, 2),
                                va.transpose(1, 2), causal=True,
                                backend=backend).transpose(1, 2)
    else:
        o = _chunked_causal_attention(q, ka, va, cfg)
    return _out(p, o, cfg, plan, mp), (k, v)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, cache_len: int, dtype,
                  device, mp=None, mode: str = "tp") -> dict[str, torch.Tensor]:
    """One layer's KV cache buffers (B, S, Hkv, hd); on a mesh, this rank's
    block: (B, S, Hkv/m, hd) in mode "tp" where the model axis divides
    Hkv (else whole), (B, S/m, Hkv, hd) in mode "cp".  Mode "cp" on a model
    axis that does not divide S raises: decode such a cache in mode "tp"
    (`cp_splits`, the JAX package's fallback).  `batch` is this rank's
    rows."""
    s, hkv = cache_len, cfg.n_kv_heads
    if mode == "cp" and mp is not None and mp.size > 1:
        if not cp_splits(cache_len, mp, mode):
            raise ValueError(f"decode mode 'cp': {mp.size} model ranks do "
                             f"not divide cache_len {cache_len}; use 'tp'")
        s //= mp.size
    elif mp is not None and mp.splits(hkv):
        hkv //= mp.size
    shape = (batch, s, hkv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cp_splits(cache_len: int, mp, mode: str) -> bool:
    """Whether decode mode `mode` runs context-parallel: "cp" on a mesh
    whose model axis divides the cache length (the JAX package's rule)."""
    if mode not in ("tp", "cp"):
        raise ValueError(f"unknown decode mode {mode!r}")
    return mode == "cp" and mp is not None and mp.splits(cache_len)


def _update_cache(cache_arr, new, pos):
    """Write new (B,1,Hkv,hd) at per-example positions pos (B,), in place.
    The JAX package's `dynamic_update_slice` clamps a position past the
    end; an index write does not, so positions must lie inside the cache
    (the serving engine keeps them below cache_len - 1 and checks it)."""
    rows = torch.arange(cache_arr.shape[0], device=cache_arr.device)
    cache_arr[rows, pos.long()] = new[:, 0].to(cache_arr.dtype)
    return cache_arr


def _decode_attend(q, ck, cv, pos, scale):
    """q (B,1,H,hd); ck/cv (B,S,Hkv,hd); keys at k_pos <= pos[b]."""
    logits = _gqa_logits(q, ck, scale)                       # (B,Hkv,g,1,S)
    k_pos = torch.arange(ck.shape[1], device=q.device)
    mask = k_pos[None, :] <= pos[:, None]                    # (B,S)
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    return _gqa_out(torch.softmax(logits, dim=-1), cv)       # (B,1,H,hd) f32


def attention_decode(p, x, cfg, cache, pos, mode: str = "tp", mp=None):
    """One-token decode step.  x (B,1,D), pos (B,) current positions.  On a
    mesh (`mp`) x and pos are this rank's rows and the cache this rank's
    block in `mode`'s layout (`init_kv_cache`; mode "cp" on a model axis
    needs the sequence split, `cp_splits`).

    Returns (out (B,1,D), cache) with the cache written in place.
    """
    if mode not in ("tp", "cp"):
        raise ValueError(f"unknown decode mode {mode!r}")
    plan = head_plan(cfg, mp)
    q, k_new, v_new = _project_qkv(p, x, cfg,
                                   pos[:, None].to(torch.float32), plan, mp)
    if mode == "cp" and plan is not None:
        o = _cp_decode(q, k_new, v_new, cache, pos, cfg, plan, mp)
    else:
        ck = _update_cache(cache["k"], k_new, pos)
        cv = _update_cache(cache["v"], v_new, pos)
        o = _decode_attend(q, _kv_heads(ck, plan), _kv_heads(cv, plan), pos,
                           cfg.hd ** -0.5)
    return _out(p, o.to(x.dtype), cfg, plan, mp), cache


def _cp_decode(q, k_new, v_new, cache, pos, cfg, plan, mp):
    """Context-parallel decode: this rank holds cache slots [r S_l,
    (r + 1) S_l) of every kv head.  q and the new keys and values are
    gathered to every head; the owning rank writes the new key and value;
    each rank forms the partial softmax statistics over its slots, which an
    all-reduce MAX (the max) and one SUM (the sum and the weighted values)
    combine: distributed flash-decoding.  Returns (B,1,H or this rank's
    heads,hd) f32."""
    qf = q
    if plan.split:      # one gather: (B,1,heads,m*hd), then rank-major heads
        hq, hk = q.shape[2], k_new.shape[2] if plan.kv_split else 0
        parts = [q, k_new, v_new] if hk else [q]
        every = mp.gather(torch.cat(parts, 2).contiguous(), 3)
        every = every.unflatten(3, (mp.size, -1)).movedim(3, 2)

        def heads(a, b):
            return every[:, :, :, a:b].flatten(2, 3)
        qf = heads(0, hq)
        if hk:
            k_new, v_new = heads(hq, hq + hk), heads(hq + hk, hq + 2 * hk)
    ck, cv = cache["k"], cache["v"]
    s_loc = ck.shape[1]
    start = mp.rank * s_loc
    loc = pos - start
    mine = ((loc >= 0) & (loc < s_loc))[:, None, None]
    rows = torch.arange(ck.shape[0], device=ck.device)
    at = loc.clamp(0, s_loc - 1)
    ck[rows, at] = torch.where(mine, k_new[:, 0].to(ck.dtype), ck[rows, at])
    cv[rows, at] = torch.where(mine, v_new[:, 0].to(cv.dtype), cv[rows, at])
    logits = _gqa_logits(qf, ck, cfg.hd ** -0.5)             # (B,Hkv,g,1,Sl)
    k_pos = start + torch.arange(s_loc, device=q.device)
    mask = k_pos[None, :] <= pos[:, None]
    logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
    m_glob = mp.all_reduce(logits.amax(-1), dist.ReduceOp.MAX)
    w = torch.exp(logits - m_glob[..., None])
    acc = torch.einsum("bhgcs,bshd->bhgcd", w, cv.to(torch.float32))
    stats = mp.all_reduce(torch.cat([w.sum(-1)[..., None], acc], -1))
    o = stats[..., 1:] / torch.clamp(stats[..., :1], min=1e-30)
    b, hkv, g, c, hd = o.shape
    o = o.permute(0, 3, 1, 2, 4).reshape(b, c, hkv * g, hd)
    if plan.split:
        o = o[:, :, plan.q0:plan.q0 + plan.hq]
    return o


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def encode_kv(p, enc_out, cfg) -> dict[str, torch.Tensor]:
    """Project the encoder's output (B, F, D) once into the cross-attention's
    keys and values {"k", "v"} (B, F, Hkv, hd): no RoPE, no norm (a static
    cache during decode)."""
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    return {"k": (enc_out @ p["cross_wk"]).reshape(b, s, hkv, hd),
            "v": (enc_out @ p["cross_wv"]).reshape(b, s, hkv, hd)}


def cross_attention(p, x, cfg, cross_kv, enc_valid_len=None):
    """x (B, S, D) attends over the encoder's keys and values (no causal
    mask); `enc_valid_len` (B,), when given, masks the keys at positions
    from it on.  f32 logits and softmax; out (B, S, D)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    q = (x @ p["cross_wq"]).reshape(b, s, h, hd)
    logits = _gqa_logits(q, cross_kv["k"], hd ** -0.5)
    if enc_valid_len is not None:
        k_pos = torch.arange(cross_kv["k"].shape[1], device=x.device)
        keep = k_pos[None, :] < torch.as_tensor(enc_valid_len,
                                                device=x.device)[:, None]
        logits = torch.where(keep[:, None, None, None, :], logits, NEG_INF)
    o = _gqa_out(torch.softmax(logits, dim=-1), cross_kv["v"]).to(x.dtype)
    return o.reshape(b, s, -1) @ p["cross_wo"]
