"""Mixture-of-Experts FFN: a top-k router and the expert SwiGLU FFNs over
capacity-bounded dispatch (the port of `repro/models/moe.py`).

Implementations (cfg.moe.impl), each with the reference's own dataflow
and dtypes:
  capacity — dispatch / combine einsums over (B, S, E, C) one-hot tensors
             per sequence, capacity C = min(ceil(S k / E * cf), S); the
             default, and the fallback for any other name, as in the
             reference;
  dense    — every expert on every token, weighted by the router's gates
             (the drop-free oracle);
  gather   — the capacity slots of `_capacity_slots`, filled by a gather
             and combined by a scatter-add;
  hybrid   — the gather dispatch with the einsum combine;
  ragged   — tokens sorted by expert, one matrix product per expert group
             (the reference's `lax.ragged_dot`, which is not a Pallas
             kernel), drop-free.

The router is f32 whatever the model's dtype; its top-k breaks ties to
the lower expert, as `lax.top_k` does (a stable sort: `torch.topk` leaves
the order of ties unspecified on the card).  The expert FFN calls
`ops.swiglu` with the model's backend, so on the card the swiglu kernel
(and, where autograd records, its backward kernel) runs once a layer on
the expert-grouped (B, E, C, d_ff) tensor; the reference calls its plain
version there, which computes the same function.

On a mesh (`mp`, a `distributed.shardings.ModelMesh` whose model axis
divides E) each rank holds experts [r E/n, (r+1) E/n) of the n model
ranks, and tokens are whole on every model rank: the layout that the
reference's sharding hints (`constrain` of the grouped tokens to
(batch, "model", None, None), `res_constrain` of the output) ask GSPMD
for.  The router runs on every rank on the same input, before the
model-parallel region, and the capacity slots, positions or sorted rows
are those of one device (an expert's positions depend only on its own
counts); the rank then computes its experts' share of the output for all
of its tokens, and one `reduce_from_model` (an f32 sum, cast back) joins
the ranks, the all-reduce that the reference's note on the scatter-add
combine names.  The input and the gates enter the region through
`copy_to_model`, so their gradients (and the router's) sum every rank's
experts; an expert's gradient lives on its one rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.shardings import copy_to_model, reduce_from_model
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init

__all__ = ["init_moe", "moe_apply", "moe_shapes", "capacity"]


def moe_shapes(cfg, dtype) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of the MoE tensors of one block: the router
    f32, the experts in `dtype`."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    return {"router": ((d, e), torch.float32),
            "we_g": ((e, d, f), dtype), "we_u": ((e, d, f), dtype),
            "we_d": ((e, f, d), dtype)}


def init_moe(gen: torch.Generator, cfg, dtype):
    """(name, tensor) pairs, each drawn when asked for: the router (d, E)
    f32 and the experts' gate, up (E, d, f) and down (E, f, d)
    projections, normal scaled by fan-in^-0.5, drawn in f32 on the
    generator's device and cast to `dtype`."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)
    yield "router", dense_init(gen, d, e, torch.float32)
    yield "we_g", normal((e, d, f), d)
    yield "we_u", normal((e, d, f), d)
    yield "we_d", normal((e, f, d), f)


def capacity(cfg, s: int) -> int:
    """Slots per expert and sequence: min(ceil(S k / E * cf), S)."""
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    return min(int(math.ceil(s * k / e * cfg.moe.capacity_factor)), s)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, x, cfg):
    """-> (top_p (B, S, k) f32 renormalised, top_i (B, S, k) int64)."""
    logits = x.to(torch.float32) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top_k(probs, cfg.moe.top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_i


def _expert_ffn(xe, p, backend: str = "auto"):
    """xe (B, E, C, D) grouped tokens -> the experts' SwiGLU FFN."""
    g = torch.einsum("becd,edf->becf", xe, p["we_g"]).contiguous()
    u = torch.einsum("becd,edf->becf", xe, p["we_u"]).contiguous()
    h = ops.swiglu(g, u, backend=backend)
    return torch.einsum("becf,efd->becd", h, p["we_d"])


def moe_apply(p, x, cfg, backend: str = "auto", mp=None):
    """x (B, S, D) -> the MoE FFN's output (B, S, D) in x's dtype.  `mp`:
    the mesh whose model axis splits the experts (`ModelMesh.splits(E)`);
    p's expert tensors are then this rank's (E/n, ...) blocks and the
    router whole, and the output is the sum over the model ranks."""
    if mp is not None and not mp.splits(cfg.moe.n_experts):
        raise ValueError(f"the model axis of {mp.size} does not split "
                         f"{cfg.moe.n_experts} experts")
    fn = {"dense": _moe_dense, "ragged": _moe_ragged, "gather": _moe_gather,
          "hybrid": _moe_hybrid}.get(cfg.moe.impl, _moe_capacity)
    return fn(p, x, cfg, backend, mp)


def _positions(top_i_j, e: int, counts, lo: int = 0, hi: int | None = None):
    """For choice j and experts [lo, hi): m_j (B, S, hi - lo) int32 one-hot
    of the expert, and each token's position in its expert's buffer after
    the `counts` taken by earlier choices (token order priority)."""
    m_j = F.one_hot(top_i_j, e)[..., lo:hi].to(torch.int32)
    pos_j = torch.cumsum(m_j, dim=1, dtype=torch.int32) - 1 \
        + counts[:, None, :]
    return m_j, pos_j


def _capacity_slots(top_p, top_i, e: int, cap: int, lo: int = 0,
                    hi: int | None = None):
    """For each (batch, expert in [lo, hi), slot): the source token
    (int64), whether the slot is filled, and its gate weight (f32).
    Tokens past an expert's capacity are dropped, in the order of
    `_moe_capacity`."""
    b, s, k = top_i.shape
    n = (e if hi is None else hi) - lo
    dev = top_i.device
    # one spare slot takes the writes the reference drops (mode="drop")
    src = torch.zeros((b, n, cap + 1), dtype=torch.int64, device=dev)
    hit = torch.zeros((b, n, cap + 1), dtype=torch.bool, device=dev)
    wslot = torch.zeros((b, n, cap + 1), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, n), dtype=torch.int32, device=dev)
    tok = torch.arange(s, device=dev)[None, None, :].expand(b, n, s)
    for j in range(k):
        m_j, pos_j = _positions(top_i[..., j], e, counts, lo, hi)
        keep = (m_j > 0) & (pos_j < cap)                       # (B, S, n)
        pos_c = torch.where(keep, pos_j, cap).long().transpose(1, 2)
        src = src.scatter(2, pos_c, tok)
        hit = hit.scatter(2, pos_c, torch.ones_like(pos_c, dtype=torch.bool))
        wslot = wslot.scatter(
            2, pos_c, top_p[..., j][:, None, :].expand(b, n, s))
        counts = counts + m_j.sum(1, dtype=torch.int32)
    return src[..., :cap], hit[..., :cap], wslot[..., :cap]


def _gathered(x, src, hit):
    """xe (B, E, C, D): each slot's source token, zero where unfilled."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[bidx, src] * hit[..., None].to(x.dtype)


def _routed(p, x, cfg, mp):
    """The router on x, then x and the gates as they enter this rank's
    experts [lo, hi) (all E without a mesh): -> (x, top_p, top_i, lo,
    hi)."""
    top_p, top_i = _router(p, x, cfg)
    e = cfg.moe.n_experts
    lo, hi = (0, e) if mp is None else (mp.rank * e // mp.size,
                                        (mp.rank + 1) * e // mp.size)
    return copy_to_model(x, mp), copy_to_model(top_p, mp), top_i, lo, hi


def _moe_hybrid(p, x, cfg, backend, mp):
    """Gather dispatch and einsum combine."""
    s, e = x.shape[1], cfg.moe.n_experts
    x, top_p, top_i, lo, hi = _routed(p, x, cfg, mp)
    src, hit, wslot = _capacity_slots(top_p, top_i, e, capacity(cfg, s),
                                      lo, hi)
    ye = _expert_ffn(_gathered(x, src, hit), p, backend)
    oh = (src[..., None] == torch.arange(s, device=x.device)).to(
        torch.float32)                                         # (B,E,C,S)
    combine = (oh * (wslot * hit)[..., None]).to(x.dtype)
    return reduce_from_model(
        torch.einsum("becs,becd->bsd", combine, ye.to(x.dtype)), mp)


def _moe_gather(p, x, cfg, backend, mp):
    """The capacity layout with a gather dispatch and a scatter-add
    combine in the compute dtype."""
    b, s, d = x.shape
    e = cfg.moe.n_experts
    x, top_p, top_i, lo, hi = _routed(p, x, cfg, mp)
    src, hit, wslot = _capacity_slots(top_p, top_i, e, capacity(cfg, s),
                                      lo, hi)
    ye = _expert_ffn(_gathered(x, src, hit), p, backend)
    yw = (ye.to(torch.float32) * (wslot * hit)[..., None]).to(x.dtype)
    bidx = torch.arange(b, device=x.device)[:, None, None].expand_as(src)
    out = torch.zeros((b, s, d), dtype=x.dtype, device=x.device)
    return reduce_from_model(out.index_put((bidx, src), yw, accumulate=True),
                             mp)


def _moe_dense(p, x, cfg, backend, mp):
    b, s, _ = x.shape
    e = cfg.moe.n_experts
    x, top_p, top_i, lo, hi = _routed(p, x, cfg, mp)
    gates = torch.zeros((b, s, e), dtype=torch.float32,
                        device=x.device).scatter_add(-1, top_i, top_p)
    g = torch.einsum("bsd,edf->bsef", x, p["we_g"]).contiguous()
    u = torch.einsum("bsd,edf->bsef", x, p["we_u"]).contiguous()
    h = ops.swiglu(g, u, backend=backend)
    y = torch.einsum("bsef,efd->bsed", h, p["we_d"])
    out = torch.einsum("bsed,bse->bsd", y.to(torch.float32),
                       gates[..., lo:hi])
    return reduce_from_model(out, mp).to(x.dtype)


def _moe_capacity(p, x, cfg, backend, mp):
    """Dispatch / combine einsums; each sequence is a routing group."""
    b, s, _ = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = capacity(cfg, s)
    x, top_p, top_i, lo, hi = _routed(p, x, cfg, mp)
    slots = torch.arange(cap, device=x.device)
    # Position of each (token, choice) within its expert's capacity buffer.
    combine = torch.zeros((b, s, hi - lo, cap), dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros((b, hi - lo), dtype=torch.int32, device=x.device)
    for j in range(k):
        m_j, pos_j = _positions(top_i[..., j], e, counts, lo, hi)
        keep = (m_j > 0) & (pos_j < cap)
        pos_c = torch.clamp(pos_j, 0, cap - 1)
        oh = (pos_c[..., None] == slots).to(torch.float32) * keep[..., None]
        combine = combine + oh * top_p[..., j][..., None, None] \
            * m_j[..., None]
        counts = counts + m_j.sum(1, dtype=torch.int32)
    dispatch = (combine > 0).to(x.dtype)                       # (B,S,E,C)
    xe = torch.einsum("bsd,bsec->becd", x, dispatch)           # (B,E,C,D)
    ye = _expert_ffn(xe, p, backend)
    out = torch.einsum("becd,bsec->bsd", ye.to(torch.float32), combine)
    return reduce_from_model(out, mp).to(x.dtype)


def _ragged_dot(xs, w, sizes: list[int]):
    """Rows grouped by expert (sizes[e] rows each, in expert order) times
    each group's expert matrix w[e]."""
    outs = [part @ w[i] for i, part in enumerate(torch.split(xs, sizes))]
    return torch.cat(outs, 0)


def _group_sizes(flat_e: torch.Tensor, e: int) -> list[int]:
    """Rows per expert.  A meta tensor holds no routing: there (the dry
    run) the same rows split evenly, which costs the grouped products the
    same FLOPs and bytes as any routing."""
    if flat_e.device.type == "meta":
        q, r = divmod(flat_e.numel(), e)
        return [q + (i < r) for i in range(e)]
    return torch.bincount(flat_e, minlength=e).tolist()


def _moe_ragged(p, x, cfg, backend, mp):
    """Sort by expert, one product per expert group: drop-free.  This
    rank's experts are a contiguous run of the sorted rows."""
    b, s, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    x, top_p, top_i, lo, hi = _routed(p, x, cfg, mp)
    t = b * s
    xf = x.reshape(t, d)
    flat_e = top_i.reshape(t * k)
    flat_w = top_p.reshape(t * k)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sizes = _group_sizes(flat_e, e)
    start = sum(sizes[:lo])
    order = order[start:start + sum(sizes[lo:hi])]
    sizes = sizes[lo:hi]
    rows = flat_tok[order]
    xe = xf[rows]                                              # (rows, D)
    g = _ragged_dot(xe, p["we_g"], sizes)
    u = _ragged_dot(xe, p["we_u"], sizes)
    h = ops.swiglu(g, u, backend=backend)
    y = _ragged_dot(h, p["we_d"], sizes)                       # (rows, D)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, rows, y.to(torch.float32) * flat_w[order][:, None])
    return reduce_from_model(out, mp).reshape(b, s, d).to(x.dtype)
