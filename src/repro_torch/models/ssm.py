"""Mamba2-style SSD (state-space duality) block of the hybrid family.

The port of `repro/models/ssm.py`: a single B/C group shared across heads,
a scalar A per head, a depthwise causal conv on the x branch, a gated
RMSNorm before the output projection.  Training and prefill run the
chunked SSD form: within a chunk of Q tokens the recurrence is a masked
(Q x Q) product (a decay mask, like attention's); across chunks a Python
loop carries the (B, H, hd, N) f32 state.  Decode is the O(1) recurrent
update.

Arithmetic as the JAX package's: where it takes a product of compute-dtype
operands with f32 accumulation (`preferred_element_type`), the operands
are rounded to the compute dtype and then widened to f32 (a product of two
bf16 values is exact in f32), so the product never rounds to bf16.  One
difference: the intra-chunk decay is `exp(where(tri, mdiff, -inf))`, not
`where(tri, exp(mdiff), 0)`.  The values are the same (the masked entries
are 0 both ways), but above the diagonal `mdiff` is a sum of up to Q - 1
terms dt |A|, whose exp overflows to inf at the configs' chunk of 256;
`where` hides the inf in the forward and its gradient 0 * inf is NaN.
The form here has finite gradients at every chunk.

State cache for decode: {"conv": (B, w-1, d_inner) in the model dtype,
"ssm": (B, H, hd, N) f32}; `mamba_decode` writes it in place.

On a mesh (`mp`, a `distributed.shardings.ModelMesh`) whose model axis
divides H (`ModelMesh.splits`), rank r of the n model ranks runs heads
[r H/n, (r+1) H/n): its d_inner/n columns of z and x, its heads' dt, and
B and C whole.  The parameters keep the JAX package's layout, whose rule
splits the packed in_w's columns (z | x | B | C | dt) contiguously over
the model axis, which does not line up with the heads: each rank
multiplies by its columns and the projection is gathered whole over the
model axis (`gather_model(partial=True)`: the gradient of B and C sums
every rank's heads), then the rank takes its slices.  conv_w, a_log and
d_skip are split by the same rule into blocks that line up with the
rank's x columns and heads; out_w is split by rows, a row-parallel
product summed over the ranks (`reduce_from_model`).  The gated norm's
mean spans d_inner, so each rank's f32 sum of squares is added over the
model ranks (`sum_over_model`, whose backward sums too).  The input and
the replicated leaves a rank uses a slice of (gn, dt_bias) enter through
`copy_to_model`, so their gradients sum every rank's part.  Where the axis
does not divide H, every rank runs every head on weights gathered whole
(`model_whole`), with no collective in the block.  The cache is this
rank's block: conv (B, w-1, d_inner/n), ssm (B, H/n, hd, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.shardings import (
    copy_to_model, gather_model, model_whole, reduce_from_model,
    sum_over_model,
)
from repro_torch.models.layers import dense_init

__all__ = ["init_mamba", "mamba_shapes", "mamba_train", "mamba_decode",
           "init_ssm_cache"]

_F32 = ("a_log", "dt_bias", "d_skip")   # f32 in a model of any dtype


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state


def mamba_shapes(cfg, dtype) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Names, shapes and dtypes of the block's Mamba tensors (`init_mamba`
    makes them): a_log, dt_bias and d_skip f32, the rest in `dtype`."""
    d = cfg.d_model
    d_inner, h, n = _dims(cfg)
    shapes = {"in_w": (d, 2 * d_inner + 2 * n + h),
              "conv_w": (cfg.conv_width, d_inner), "a_log": (h,),
              "dt_bias": (h,), "d_skip": (h,), "gn": (d_inner,),
              "out_w": (d_inner, d)}
    return {k: (s, torch.float32 if k in _F32 else dtype)
            for k, s in shapes.items()}


def init_mamba(gen: torch.Generator, cfg, dtype) -> dict[str, torch.Tensor]:
    """The JAX package's distributions: the projections normal scaled by
    fan-in^-0.5, the conv normal * width^-0.5, a_log and dt_bias 0, d_skip
    and the gated norm's weight 1."""
    d = cfg.d_model
    d_inner, h, n = _dims(cfg)
    dev = gen.device
    conv = torch.randn((cfg.conv_width, d_inner), generator=gen, device=dev,
                       dtype=torch.float32) * cfg.conv_width ** -0.5

    def f32(v):
        return torch.full((h,), v, dtype=torch.float32, device=dev)
    return {"in_w": dense_init(gen, d, 2 * d_inner + 2 * n + h, dtype),
            "conv_w": conv.to(dtype), "a_log": f32(0.0),
            "dt_bias": f32(0.0), "d_skip": f32(1.0),
            "gn": torch.ones((d_inner,), dtype=dtype, device=dev),
            "out_w": dense_init(gen, d_inner, d, dtype)}


def _split(cfg, mp) -> bool:
    """Whether the model axis splits the heads (the rank runs H/n)."""
    return mp is not None and mp.splits(_dims(cfg)[1])


def _split_in(p, x, cfg, mp=None):
    """x (B, S, D) -> z, xs (the model dtype), B, C, dt (f32, softplus): on
    a mesh that splits the heads, this rank's z, xs and dt and the whole B
    and C; elsewhere every head's."""
    d_inner, h, n = _dims(cfg)
    cols = 2 * d_inner + 2 * n + h
    if not _split(cfg, mp):
        proj = x @ model_whole(p["in_w"], 1, cols, mp, False)
        z, xs, bb, cc, dt = torch.split(proj, [d_inner, d_inner, n, n, h],
                                        -1)
        dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
        return z, xs, bb.to(torch.float32), cc.to(torch.float32), dt
    x = copy_to_model(x, mp)
    if mp.splits(cols):
        proj = gather_model(x @ p["in_w"], -1, mp, True)
    else:
        proj = x @ model_whole(p["in_w"], 1, cols, mp, True)
    di, hh, r = d_inner // mp.size, h // mp.size, mp.rank
    z = proj[..., r * di:(r + 1) * di]
    xs = proj[..., d_inner + r * di:d_inner + (r + 1) * di]
    bb = proj[..., 2 * d_inner:2 * d_inner + n]
    cc = proj[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    at = 2 * d_inner + 2 * n + r * hh
    dt_bias = copy_to_model(p["dt_bias"], mp)[r * hh:(r + 1) * hh]
    dt = F.softplus(proj[..., at:at + hh].to(torch.float32) + dt_bias)
    return z, xs, bb.to(torch.float32), cc.to(torch.float32), dt


def _local(p, cfg, mp):
    """(conv_w, a_log, d_skip, gn, out_w) as this rank runs them: its
    blocks where the axis splits the heads (gn's slice through
    `copy_to_model`), else whole."""
    d_inner, h, _ = _dims(cfg)
    if not _split(cfg, mp):
        return (model_whole(p["conv_w"], 1, d_inner, mp, False), p["a_log"],
                p["d_skip"], p["gn"],
                model_whole(p["out_w"], 0, d_inner, mp, False))
    di = d_inner // mp.size
    gn = copy_to_model(p["gn"], mp)[mp.rank * di:(mp.rank + 1) * di]
    return p["conv_w"], p["a_log"], p["d_skip"], gn, p["out_w"]


def _conv_causal(xs, w, state=None):
    """Depthwise causal conv of width w.shape[0] in xs's dtype, then SiLU;
    state (B, w-1, d_inner) holds the inputs before xs (zeros when None).
    -> (out, the last w-1 inputs)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros(xs.shape[:1] + (width - 1,) + xs.shape[2:],
                          dtype=xs.dtype, device=xs.device)
    else:
        pad = state.to(xs.dtype)
    xp = torch.cat([pad, xs], 1)
    s = xs.shape[1]
    out = xp[:, 0:s] * w[0].to(xs.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i].to(xs.dtype)
    return F.silu(out.to(torch.float32)).to(xs.dtype), xp[:, s:]


def _gated_norm(y, z, gn, eps, mp=None, width=None):
    """RMSNorm of y * silu(z) over the last dim, f32 (plain torch, as the
    JAX package's is plain jnp).  On a mesh that splits the heads, y and z
    are this rank's columns of `width`: the sum of squares is added over
    the model ranks."""
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if mp is None:
        ms = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        ms = sum_over_model(torch.sum(yf * yf, dim=-1, keepdim=True),
                            mp) / width
    return yf * torch.rsqrt(ms + eps) * gn.to(torch.float32)


def _out(y, z, gn, out_w, x, cfg, mp):
    """The gated norm of y (B, S, this rank's d_inner) and the output
    projection -> (B, S, D), summed over the model ranks where they split
    the heads."""
    split = _split(cfg, mp)
    y = _gated_norm(y, z, gn, cfg.norm_eps, mp if split else None,
                    _dims(cfg)[0])
    out = y.to(x.dtype) @ out_w
    return reduce_from_model(out, mp) if split else out


def _chunk(state, xck, bk, ck, dk, a, tri, cdt):
    """One chunk of the SSD scan: xck (B, q, H, hd) in cdt; bk, ck (B, q,
    N) rounded to cdt; dk (B, q, H) f32; state (B, H, hd, N) f32.
    -> (state after the chunk, y (B, q, H, hd) f32)."""
    f32 = torch.float32
    la = dk * a                                          # (B, q, H) log-decay
    cum = torch.cumsum(la, 1)                            # inclusive
    mdiff = cum[:, :, None, :] - cum[:, None, :, :]      # (B, t, s, H)
    m = torch.exp(torch.where(tri[None, :, :, None], mdiff, -torch.inf))
    g = torch.einsum("btn,bsn->bts", ck.to(f32), bk.to(f32))
    w = g[..., None] * m * dk[:, None, :, :]             # (B, t, s, H) f32
    xf = xck.to(f32)
    y_intra = torch.einsum("btsh,bshd->bthd", w.to(cdt).to(f32), xf)
    # inter-chunk: y_inter[t] = exp(cum_t) C_t . state
    y_inter = torch.einsum("btn,bhdn->bthd", ck.to(f32), state) \
        * torch.exp(cum)[..., None]
    # S' = exp(cum_end) S + sum_s exp(cum_end - cum_s) dt_s x_s B_s^T
    coef = dk * torch.exp(cum[:, -1:, :] - cum)          # (B, q, H)
    upd = torch.einsum("bshd,bsn->bhdn", xf * coef[..., None], bk.to(f32))
    state = state * torch.exp(cum[:, -1])[:, :, None, None] + upd
    return state, y_intra + y_inter


def mamba_train(p, x, cfg, mp=None):
    """x (B, S, D) -> (out (B, S, D), {"conv", "ssm"}: the cache after the
    sequence, this rank's block on a mesh).  The chunk is cfg.ssm_chunk,
    or S when it does not divide S."""
    b, s, _ = x.shape
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    conv_w, a_log, d_skip, gn, out_w = _local(p, cfg, mp)
    z, xs, bb, cc, dt = _split_in(p, x, cfg, mp)
    h = dt.shape[-1]
    xs, conv_state = _conv_causal(xs, conv_w)
    a = -torch.exp(a_log)                                # (H,) negative
    q = min(cfg.ssm_chunk, s)
    if s % q:
        q = s
    cdt = xs.dtype
    xh = xs.reshape(b, s // q, q, h, hd)
    bbc = bb.reshape(b, s // q, q, n).to(cdt)
    ccc = cc.reshape(b, s // q, q, n).to(cdt)
    dtc = dt.reshape(b, s // q, q, h)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(s // q):
        state, y = _chunk(state, xh[:, c], bbc[:, c], ccc[:, c], dtc[:, c],
                          a, tri, cdt)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, s, h, hd)
    y = y + xs.to(torch.float32).reshape(b, s, h, hd) \
        * d_skip[None, None, :, None]
    out = _out(y.reshape(b, s, h * hd), z, gn, out_w, x, cfg, mp)
    return out, {"conv": conv_state, "ssm": state}


def init_ssm_cache(cfg, batch: int, dtype, device,
                   mp=None) -> dict[str, torch.Tensor]:
    """A layer's zeroed state; on a mesh that splits the heads, this
    rank's block (d_inner/n columns of conv, H/n heads of ssm)."""
    d_inner, h, n = _dims(cfg)
    if _split(cfg, mp):
        d_inner, h = d_inner // mp.size, h // mp.size
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, d_inner),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                               dtype=torch.float32, device=device)}


def mamba_decode(p, x, cfg, cache, mp=None):
    """One-token recurrent update.  x (B, 1, D) -> out (B, 1, D); the cache
    (this rank's block on a mesh) is written in place."""
    b = x.shape[0]
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    conv_w, a_log, d_skip, gn, out_w = _local(p, cfg, mp)
    z, xs, bb, cc, dt = _split_in(p, x, cfg, mp)
    h = dt.shape[-1]
    xs, conv_state = _conv_causal(xs, conv_w, cache["conv"])
    a = -torch.exp(a_log)
    xh = xs.reshape(b, h, hd).to(torch.float32)
    dt1 = dt.reshape(b, h)
    da = torch.exp(dt1 * a[None, :])                     # (B, H)
    upd = torch.einsum("bhd,bn->bhdn", xh * dt1[..., None], bb.reshape(b, n))
    state = cache["ssm"] * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhdn->bhd", cc.reshape(b, n), state)
    y = y + xh * d_skip[None, :, None]
    out = _out(y.reshape(b, 1, h * hd), z, gn, out_w, x, cfg, mp)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(state)
    return out
