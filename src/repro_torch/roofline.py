"""Roofline terms and the analytic cost model of one (arch x shape) cell on
an NVIDIA H100 (the port of `repro/roofline.py`).

Three terms per cell, all in seconds:

  compute    = FLOPs_per_device / peak_FLOPs_per_card (bf16)
  memory     = HBM_bytes_per_device / HBM_bw_per_card
  collective = collective_bytes_per_device / link_bw_per_card

The FLOPs and bytes are the analytic model's below (`analytic_flops`,
`analytic_bytes`), copied from the JAX package with the same names,
arguments and order of operations, so that they give the same numbers bit
for bit; `model_flops` is the 6·N·D convention.  The measured counterpart is
`meta_flop_count`: the matmul and attention FLOPs of a callable run on meta
tensors, counted by `torch.utils.flop_counter.FlopCounterMode` (it sees aten
ops only, so a hand-written kernel's work is invisible to it; on the meta
device every op takes its plain version, which it does see).

One card has no collectives: the dry run reports zero collective bytes.
Counting them (the counterpart of the JAX package's HLO parse) waits for the
multi-card slice.

Hardware constants: NVIDIA H100 SXM data sheet, dense — 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s f32 outside them, 3.35 TB/s HBM3, 450 GB/s a
direction of NVLink 4; and the device memory the card reports.
"""
from __future__ import annotations

import math

__all__ = ["HW", "meta_flop_count", "roofline_terms", "model_flops",
           "active_params", "analytic_flops", "analytic_bytes"]

PEAK_FLOPS = 989e12          # bf16 per card
PEAK_FLOPS_F32 = 67e12       # f32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink 4, bytes/s a direction; unused on one card
# The device memory that `torch.cuda.get_device_properties(0).total_memory`
# reports on this card (81,559 MiB in nvidia-smi, less what CUDA reserves).
CARD_NAME = "NVIDIA H100 80GB HBM3"
HBM_BYTES = 85_017_493_504

HW = {"peak_flops": PEAK_FLOPS, "peak_flops_f32": PEAK_FLOPS_F32,
      "hbm_bw": HBM_BW, "link_bw": LINK_BW, "hbm_bytes": HBM_BYTES}


def meta_flop_count(fn, *args, **kwargs) -> tuple[object, int]:
    """-> (fn(*args, **kwargs), the FLOPs of the aten ops it ran), counted
    by `FlopCounterMode`: matrix products (mm, bmm, addmm, baddbmm, and
    einsum / matmul through them), convolutions and the fused attention
    ops, at 2 per multiply-add; elementwise work is not counted.  Meant for
    arguments on the meta device, where nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, counter.get_total_flops()


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    compute = flops_per_dev / PEAK_FLOPS
    memory = bytes_per_dev / HBM_BW
    collective = coll_bytes_per_dev / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=lambda k: terms[k])
    terms["dominant"] = dom
    bound = max(compute, memory, collective)
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(arch, shape, n_params: int, n_active: int | None = None) -> float:
    """MODEL_FLOPS: 6*N*D train / 2*N*D forward, N_active for MoE."""
    n = n_active if n_active is not None else n_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch   # decode: one token per example


def active_params(arch, n_params: int, model=None) -> int:
    """N_active for MoE archs: expert params scaled by top_k / n_experts."""
    if arch.moe is None:
        return n_params
    e, k = arch.moe.n_experts, arch.moe.top_k
    expert = arch.n_layers * 3 * arch.d_model * arch.d_ff * e
    return int(n_params - expert + expert * (k / e))


# ===========================================================================
# Analytic cost model (the JAX package's, unchanged).
#
# Conventions: matmul(m,n,k) = 2mnk FLOPs; T = tokens processed; causal
# attention scores cost 1/2 of full.  Train multiplier: fwd + 2x bwd + 1x
# remat recompute = 4x fwd (remat="full"), 3x without.
# ===========================================================================

def _attn_fwd_flops(cfg, t: int, s_ctx: int, causal: bool = True) -> float:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    proj = 2.0 * t * d * (2 * h * hd + 2 * hkv * hd)      # q, o, k, v
    sc = 0.5 if causal else 1.0
    scores = 2.0 * t * s_ctx * h * hd * sc * 2            # qk^T + w.v
    return proj + scores


def _mlp_fwd_flops(cfg, t: int) -> float:
    return 6.0 * t * cfg.d_model * cfg.d_ff


def _moe_fwd_flops(cfg, t: int, seq: int) -> float:
    d, f = cfg.d_model, cfg.d_ff
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    router = 2.0 * t * d * e
    experts = 6.0 * t * k * d * f
    cap = min(int(math.ceil(seq * k / e * cfg.moe.capacity_factor)), seq)
    if cfg.moe.impl == "capacity":
        dispatch = 2 * (2.0 * t * e * cap * d)   # dispatch + combine einsums
    elif cfg.moe.impl == "hybrid":
        dispatch = 2.0 * t * e * cap * d         # combine einsum only
    else:
        dispatch = 0.0                           # gather / ragged / dense
    return router + experts + dispatch


def _mamba_fwd_flops(cfg, t: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    hs = di // cfg.ssm_head_dim
    q = cfg.ssm_chunk
    in_proj = 2.0 * t * d * (2 * di + 2 * n + hs)
    conv = 2.0 * t * di * cfg.conv_width
    intra = 2.0 * t * q * (n + di) * 0.5          # causal-masked chunk matmuls
    inter = 2.0 * t * di * n * 2                  # y_inter + state update
    out = 2.0 * t * di * d
    return in_proj + conv + intra + inter + out


def _mlstm_fwd_flops(cfg, t: int) -> float:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    q = cfg.ssm_chunk
    proj = 2.0 * t * d * (5 * d + 2 * h)          # q,k,v,og,wo + gates
    intra = 6.0 * t * q * d * 0.5                 # g, y_num, n_num (causal)
    inter = 2.0 * t * d * hd * 2                  # C.q + state outer products
    return proj + intra + inter


def _slstm_fwd_flops(cfg, t: int) -> float:
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    proj = 2.0 * t * d * (2 * d + 2 * h) + 2.0 * t * d * d
    recur = t * h * (2 * 2 * hd * hd + 8 * hd)    # zg_r/og_r matvecs + gates
    return proj + recur


def _block_fwd_flops(cfg, kind: str, t: int, s_ctx: int, seq: int) -> float:
    if kind in ("attn_mlp", "shared_attn", "enc_attn_mlp"):
        f = _attn_fwd_flops(cfg, t, s_ctx, causal=(kind != "enc_attn_mlp"))
        if cfg.d_ff:
            f += _mlp_fwd_flops(cfg, t)
        return f
    if kind == "attn_moe":
        return _attn_fwd_flops(cfg, t, s_ctx) + _moe_fwd_flops(cfg, t, seq)
    if kind == "dec_attn_mlp":
        f = _attn_fwd_flops(cfg, t, s_ctx)
        # cross attention: proj for q/o on T, kv on T_enc, scores over S_enc
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        b = max(t // max(seq, 1), 1)
        t_enc = b * cfg.frontend_len
        f += 2.0 * t * d * 2 * h * hd + 2.0 * t_enc * d * 2 * hkv * hd
        f += 2.0 * t * cfg.frontend_len * h * hd * 2
        f += _mlp_fwd_flops(cfg, t)
        return f
    if kind == "mamba":
        return _mamba_fwd_flops(cfg, t)
    if kind == "mlstm":
        return _mlstm_fwd_flops(cfg, t)
    if kind == "slstm":
        return _slstm_fwd_flops(cfg, t)
    raise ValueError(kind)


def analytic_flops(arch, shape, segments) -> dict:
    """Global forward/step FLOPs for one cell, by component."""
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    if kind in ("train", "prefill"):
        t, s_ctx = b * s, s
    else:
        t, s_ctx = b, s                           # one token, full-cache scores
    out: dict[str, float] = {}
    body = 0.0
    for (k, count, _sh) in segments:
        body += count * _block_fwd_flops(arch, k, t, s_ctx, s)
    out["body_fwd"] = body
    if arch.is_encdec:
        # the reference assigns t_enc twice; the second one holds
        t_enc = (b if kind != "train" and kind != "prefill" else b) * arch.frontend_len
        t_enc = b * arch.frontend_len
        enc = arch.enc_layers * _block_fwd_flops(arch, "enc_attn_mlp",
                                                 t_enc, arch.frontend_len, arch.frontend_len)
        if kind == "decode":
            enc = 0.0                             # encoder ran at prefill
        out["encoder_fwd"] = enc
        body += enc
    head_t = t if kind != "decode" else b
    if kind == "prefill":
        head_t = b                                # only last-position logits
    out["lm_head_fwd"] = 2.0 * head_t * arch.d_model * arch.vocab
    fwd = body + out["lm_head_fwd"]
    out["fwd_total"] = fwd
    if kind == "train":
        mult = 4.0 if arch.remat == "full" else 3.0
        out["train_mult"] = mult
        out["step_total"] = fwd * mult
    else:
        out["step_total"] = fwd
    return out


def analytic_bytes(arch, shape, segments, mesh_shape: dict,
                   n_params: int) -> dict:
    """Per-DEVICE HBM bytes for one step (the memory-roofline numerator).

    The reference's model, unchanged: TP weight shards are read once per
    matmul use (attention scores never reach HBM, as in a flash kernel);
    activations count residual-width tensors in/out per block; decode reads
    its cache shard once per token.  `mesh_shape` ({} on one card) splits
    the weights over the "model" axis and the tokens over the rest.
    """
    chips = math.prod(mesh_shape.values())
    model_ax = mesh_shape.get("model", 1)
    data_ax = chips // model_ax
    b, s = shape.global_batch, shape.seq_len
    dt = 2 if arch.dtype == "bfloat16" else 4
    d = arch.d_model
    kind = shape.kind
    t_dev = (b * s) / data_ax if kind in ("train", "prefill") else b / data_ax

    w_shard = n_params * dt / chips
    w_gathered = n_params * dt / model_ax        # what compute actually reads
    out: dict[str, float] = {}
    if kind == "train":
        # fwd + remat recompute + dgrad + wgrad weight reads; grads f32 RW;
        # AdamW: read+write mu/nu/params (f32-equivalents sharded over chips)
        out["weights"] = 4 * w_gathered
        out["optimizer"] = (n_params * (4 + 4 + 4) * 2 + n_params * 4 * 2) / chips
        act_coeff = 12.0                          # residual-width tensors per block
        n_blocks = sum(c for _, c, _ in segments) + arch.enc_layers
        out["activations"] = act_coeff * n_blocks * t_dev * d * dt * 2
        out["logits"] = 2 * t_dev * (arch.vocab / model_ax) * 4 * 2
    elif kind == "prefill":
        out["weights"] = w_gathered
        act_coeff = 6.0
        n_blocks = sum(c for _, c, _ in segments) + arch.enc_layers
        out["activations"] = act_coeff * n_blocks * t_dev * d * dt
        out["cache_write"] = _cache_bytes(arch, segments, b, s, dt) / chips
        out["logits"] = 2 * (b / data_ax) * (arch.vocab / model_ax) * 4
    else:
        out["weights"] = w_gathered               # every weight read per token
        out["cache_rw"] = _cache_bytes(arch, segments, b, s, dt) / chips
        out["activations"] = 24.0 * sum(c for _, c, _ in segments) * t_dev * d * dt
        out["logits"] = 2 * (b / data_ax) * (arch.vocab / model_ax) * 4
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def _cache_bytes(arch, segments, b: int, s: int, dt: int) -> float:
    """Global decode-state bytes across all layers."""
    total = 0.0
    for kind, count, _ in segments:
        if kind in ("attn_mlp", "attn_moe", "shared_attn", "dec_attn_mlp"):
            total += count * 2 * b * s * arch.n_kv_heads * arch.hd * dt
            if kind == "dec_attn_mlp":
                total += count * 2 * b * arch.frontend_len * arch.n_kv_heads * arch.hd * dt
        elif kind == "mamba":
            di = arch.ssm_expand * arch.d_model
            hs = di // arch.ssm_head_dim
            total += count * b * (hs * arch.ssm_head_dim * arch.ssm_state * 4
                                  + (arch.conv_width - 1) * di * dt)
        elif kind == "mlstm":
            hd = arch.d_model // arch.n_heads
            total += count * b * arch.n_heads * (hd * hd + hd) * 4
        elif kind == "slstm":
            hd = arch.d_model // arch.n_heads
            total += count * b * arch.n_heads * (3 * hd + 1) * 4
    return total
