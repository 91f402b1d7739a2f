"""GQA attention of the language model: training and prefill (chunked, or
the flash kernel), one-token decode over a slot KV cache, and the
encoder-decoder's cross-attention.

The port of `repro/models/attention.py` for one card.  `attention_train`
routes to `ops.flash_attention` when `cfg.attn_impl == "flash"` and the
activations are on a CUDA device, the counterpart of the JAX package's
`ops.on_tpu()` test; otherwise it runs the chunked attention, as the JAX
package does off the TPU.  Decode attention stays plain torch, as it is
plain jnp in the JAX package.  Decode mode "cp" (context-parallel) needs a
mesh; without one it runs as "tp", as in the JAX package.  Sharded decode
waits for the language model's half of the mesh.  Cross-attention (`encode_kv` once over the encoder's
output, then `cross_attention`: no causal mask, no RoPE) is plain torch,
f32 logits and softmax, as it is plain jnp in the JAX package.
Training runs the chunked attention, as the JAX package does (its flash
kernel has no VJP, nor has the port's: `ops.flash_attention` refuses a
tensor that needs a gradient); unless `cfg.remat` is "none", the backward
recomputes each query chunk's logits.

Unlike the JAX package, `attention_decode` writes the new key and value
into the cache tensors in place (and returns the same dict).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _project_qkv(p, x, cfg, positions):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,Hkv,hd), qk-normed + roped."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = _qk_norm(q, p["qn"], cfg.norm_eps)
        k = _qk_norm(k, p["kn"], cfg.norm_eps)
    cos, sin = rope_freqs(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


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


def attention_train(p, x, cfg, positions, backend: str = "auto"):
    """Full-sequence causal self-attention (training and prefill).

    Returns (out (B,S,D), (k, v)), the (B,S,Hkv,hd) prefill cache
    contribution.
    """
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if cfg.attn_impl == "flash" and x.device.type == "cuda":
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                backend=backend).transpose(1, 2)
    else:
        o = _chunked_causal_attention(q, k, v, cfg)
    return o.reshape(b, s, -1) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, cache_len: int, dtype,
                  device) -> dict[str, torch.Tensor]:
    """One layer's KV cache buffers (B, S, Hkv, hd)."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def attention_decode(p, x, cfg, cache, pos, mode: str = "tp", mesh=None):
    """One-token decode step.  x (B,1,D), pos (B,) current positions.

    Returns (out (B,1,D), cache) with the cache written in place.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharded decode waits for the language model's mesh, the "
            "multi-card slice after the paper's path (ROADMAP.md queue 1)")
    if mode not in ("tp", "cp"):
        raise ValueError(f"unknown decode mode {mode!r}")
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg,
                                   pos[:, None].to(torch.float32))
    ck = _update_cache(cache["k"], k_new, pos)
    cv = _update_cache(cache["v"], v_new, pos)
    o = _decode_attend(q, ck, cv, pos, cfg.hd ** -0.5).to(x.dtype)
    return o.reshape(b, 1, -1) @ p["wo"], cache


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
