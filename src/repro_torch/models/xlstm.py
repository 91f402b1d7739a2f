"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential).

The port of `repro/models/xlstm.py`, f32 inside as there.  mLSTM training
uses the chunkwise form: within a chunk the recurrence is a decay-masked
(q x q) product (like attention); across chunks a Python loop carries the
matrix state C (B, H, hd, hd) and the normalizer n (B, H, hd).  A row-max
stabilizer keeps the exponentials in f32 range; it cancels between the
numerator and the normalizer.

sLSTM has a nonlinear hidden-to-hidden recurrence (block-diagonal per
head): its input projections are computed for the whole sequence up
front, and the recurrence runs as a Python loop over time steps, one
product with the four recurrent matrices a step.

Decode for both is the O(1) recurrent update, written into the cache in
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

__all__ = ["mlstm_shapes", "init_mlstm", "mlstm_train", "mlstm_decode",
           "init_mlstm_cache", "slstm_shapes", "init_slstm", "slstm_train",
           "slstm_decode", "init_slstm_cache"]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_shapes(cfg, dtype) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    d, h = cfg.d_model, cfg.n_heads
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "ig_w": (d, h),
              "fg_w": (d, h), "og_w": (d, d), "wo": (d, d)}
    return {k: (s, dtype) for k, s in shapes.items()}


def init_mlstm(gen: torch.Generator, cfg, dtype) -> dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    return {"wq": dense_init(gen, d, d, dtype),
            "wk": dense_init(gen, d, d, dtype),
            "wv": dense_init(gen, d, d, dtype),
            "ig_w": dense_init(gen, d, h, dtype, scale=0.01),
            "fg_w": dense_init(gen, d, h, dtype, scale=0.01),
            "og_w": dense_init(gen, d, d, dtype),
            "wo": dense_init(gen, d, d, dtype)}


def _mlstm_qkv(p, x, cfg):
    """x (B, S, D) -> q, k (scaled by hd^-0.5), v (B, S, H, hd) in x's
    dtype; the input gate, the log forget gate (B, S, H) and the output
    gate (B, S, D), f32."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, h, hd) * hd ** -0.5
    v = (x @ p["wv"]).reshape(b, s, h, hd)
    it = (x @ p["ig_w"]).to(_F32)
    ft = F.logsigmoid((x @ p["fg_w"]).to(_F32) + 3.0)
    o = torch.sigmoid((x @ p["og_w"]).to(_F32))
    return q, k, v, it, ft, o


def _mlstm_chunk(c_st, n_st, qc, kc, vc, ic, fc, tri):
    """One chunk (B, cl, H, *) of the chunkwise mLSTM, f32 ->
    (C, n, y (B, cl, H, hd))."""
    cf = torch.cumsum(fc, 1)                        # (B, cl, H) log decay
    # l[t, s] = cf_t - cf_s + i_s for s <= t; the inter exponent is cf_t
    lmat = cf[:, :, None, :] - cf[:, None, :, :] + ic[:, None, :, :]
    lmat = torch.where(tri[None, :, :, None], lmat, -torch.inf)
    m_row = torch.maximum(torch.amax(lmat, 2), cf)  # (B, cl, H)
    dmat = torch.exp(lmat - m_row[:, :, None, :])   # (B, t, s, H)
    g = torch.einsum("bthd,bshd->bhts", qc, kc)
    w = g * dmat.permute(0, 3, 1, 2)
    y_num = torch.einsum("bhts,bshd->bthd", w, vc)
    n_num = torch.einsum("bshd,btsh->bthd", kc, dmat)
    inter = torch.exp(cf - m_row)                   # (B, cl, H)
    y_num = y_num + torch.einsum("bthd,bhde->bthe", qc, c_st) \
        * inter[..., None]
    n_num = n_num + n_st[:, None] * inter[..., None]
    denom = torch.abs(torch.einsum("bthd,bthd->bth", n_num, qc))
    denom = torch.maximum(denom, torch.exp(-m_row))
    y = y_num / denom[..., None]
    # the state, in absolute units
    dec_end = torch.exp(cf[:, -1:, :] - cf + ic)    # (B, cl, H)
    fin = torch.exp(cf[:, -1])                      # (B, H)
    c_st = c_st * fin[:, :, None, None] + torch.einsum(
        "bshd,bshe->bhde", kc * dec_end[..., None], vc)
    n_st = n_st * fin[..., None] + torch.einsum("bshd,bsh->bhd", kc, dec_end)
    return c_st, n_st, y


def mlstm_train(p, x, cfg):
    """x (B, S, D) -> (out (B, S, D), {"c", "n"}: the state after the
    sequence).  The chunk is cfg.ssm_chunk, or S when it does not divide
    S."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    q, k, v, it, ft, o = _mlstm_qkv(p, x, cfg)
    qf, kf, vf = q.to(_F32), k.to(_F32), v.to(_F32)
    cl = min(cfg.ssm_chunk, s)
    if s % cl:
        cl = s
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    c_st = torch.zeros((b, h, hd, hd), dtype=_F32, device=x.device)
    n_st = torch.zeros((b, h, hd), dtype=_F32, device=x.device)
    ys = []
    for i in range(s // cl):
        sl = slice(i * cl, (i + 1) * cl)
        c_st, n_st, y = _mlstm_chunk(c_st, n_st, qf[:, sl], kf[:, sl],
                                     vf[:, sl], it[:, sl], ft[:, sl], tri)
        ys.append(y)
    y = torch.cat(ys, 1).reshape(b, s, d)
    out = (y * o).to(x.dtype) @ p["wo"]
    return out, {"c": c_st, "n": n_st}


def init_mlstm_cache(cfg, batch: int, dtype=None, device=None
                     ) -> dict[str, torch.Tensor]:
    """Zeroed state, f32 whatever the model's dtype."""
    h = cfg.n_heads
    hd = cfg.d_model // h
    return {"c": torch.zeros((batch, h, hd, hd), dtype=_F32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=_F32, device=device)}


def mlstm_decode(p, x, cfg, cache):
    """One-token update.  x (B, 1, D) -> out (B, 1, D); the cache is
    written in place."""
    b = x.shape[0]
    q, k, v, it, ft, o = _mlstm_qkv(p, x, cfg)
    qf, kf, vf = (t[:, 0].to(_F32) for t in (q, k, v))
    i1, f1 = it[:, 0], ft[:, 0]                     # (B, H)
    fdec, iexp = torch.exp(f1), torch.exp(i1)
    c = cache["c"] * fdec[:, :, None, None] \
        + iexp[:, :, None, None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n = cache["n"] * fdec[..., None] + iexp[..., None] * kf
    y = torch.einsum("bhd,bhde->bhe", qf, c)
    denom = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, qf)),
                        min=1.0)
    y = (y / denom[..., None]).reshape(b, 1, -1)
    out = (y * o).to(x.dtype) @ p["wo"]
    cache["c"].copy_(c)
    cache["n"].copy_(n)
    return out


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_R_NAMES = ("zg_r", "ig_r", "fg_r", "og_r")   # the recurrent matrices


def slstm_shapes(cfg, dtype) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    shapes = {"zg_w": (d, d), "ig_w": (d, h), "fg_w": (d, h), "og_w": (d, d),
              "wo": (d, d)}
    for nm in _R_NAMES:
        shapes[nm] = (h, hd, hd if nm in ("zg_r", "og_r") else 1)
    return {k: (s, dtype) for k, s in shapes.items()}


def init_slstm(gen: torch.Generator, cfg, dtype) -> dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    p = {"zg_w": dense_init(gen, d, d, dtype),
         "ig_w": dense_init(gen, d, h, dtype, scale=0.01),
         "fg_w": dense_init(gen, d, h, dtype, scale=0.01),
         "og_w": dense_init(gen, d, d, dtype),
         "wo": dense_init(gen, d, d, dtype)}
    for nm in _R_NAMES:
        out_d = hd if nm in ("zg_r", "og_r") else 1
        p[nm] = (torch.randn((h, hd, out_d), generator=gen, device=gen.device,
                             dtype=_F32) * hd ** -0.5).to(dtype)
    return p


def init_slstm_cache(cfg, batch: int, dtype=None, device=None
                     ) -> dict[str, torch.Tensor]:
    """Zeroed state, f32 whatever the model's dtype."""
    h = cfg.n_heads
    hd = cfg.d_model // h

    def z(*shape):
        return torch.zeros(shape, dtype=_F32, device=device)
    return {"c": z(batch, h, hd), "n": z(batch, h, hd), "h": z(batch, h, hd),
            "m": z(batch, h)}


def _slstm_proj(p, x, cfg):
    """The input projections of every step at once, f32: xz, xo (..., H,
    hd), xi, xf (..., H)."""
    h = cfg.n_heads
    hd = cfg.d_model // h
    xf = x.to(_F32)
    xz = (xf @ p["zg_w"].to(_F32)).reshape(*x.shape[:-1], h, hd)
    xo = (xf @ p["og_w"].to(_F32)).reshape(*x.shape[:-1], h, hd)
    xi = xf @ p["ig_w"].to(_F32)
    xft = xf @ p["fg_w"].to(_F32)
    return xz, xo, xi, xft


def _recurrent_weights(p) -> torch.Tensor:
    """The four recurrent matrices as one (H, hd, 2 hd + 2) f32 tensor:
    columns z, o, i, f."""
    return torch.cat([p[nm].to(_F32) for nm in ("zg_r", "og_r", "ig_r",
                                                "fg_r")], -1)


def _slstm_recur(r, proj_t, st):
    """One recurrent step: r from `_recurrent_weights`, proj_t the step's
    projected inputs, st the state {"c", "n", "h", "m"} -> (state, h)."""
    xz, xo, xi, xft = proj_t
    hd = xz.shape[-1]
    rec = torch.einsum("bhd,hde->bhe", st["h"].to(_F32), r)
    rz, ro = rec[..., :hd], rec[..., hd:2 * hd]
    ri, rf = rec[..., 2 * hd], rec[..., 2 * hd + 1]
    z = torch.tanh(xz + rz)
    og = torch.sigmoid(xo + ro)
    it = xi + ri                                    # (B, H)
    ft = F.logsigmoid(xft + rf + 3.0)
    m_new = torch.maximum(ft + st["m"], it)
    i_s = torch.exp(it - m_new)[..., None]
    f_s = torch.exp(ft + st["m"] - m_new)[..., None]
    c = f_s * st["c"] + i_s * z
    n = f_s * st["n"] + i_s
    hy = og * (c / torch.clamp(n, min=1e-6))
    return {"c": c, "n": n, "h": hy, "m": m_new}, hy


def slstm_train(p, x, cfg):
    """x (B, S, D) -> (out (B, S, D), the state after the sequence): the
    recurrence one time step at a time."""
    b, s, d = x.shape
    st = init_slstm_cache(cfg, b, device=x.device)
    xz, xo, xi, xft = _slstm_proj(p, x, cfg)
    r = _recurrent_weights(p)
    hs = []
    for t in range(s):
        st, hy = _slstm_recur(r, (xz[:, t], xo[:, t], xi[:, t], xft[:, t]),
                              st)
        hs.append(hy)
    y = torch.stack(hs, 1).reshape(b, s, d).to(x.dtype) @ p["wo"]
    return y, st


def slstm_decode(p, x, cfg, cache):
    """One-token update.  x (B, 1, D) -> out (B, 1, D); the cache is
    written in place."""
    proj = _slstm_proj(p, x[:, 0], cfg)
    st, hy = _slstm_recur(_recurrent_weights(p), proj, cache)
    out = hy.reshape(x.shape[0], 1, -1).to(x.dtype) @ p["wo"]
    for k, v in st.items():
        cache[k].copy_(v)
    return out
