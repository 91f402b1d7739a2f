"""The language model's mesh on the CPU: the tensor- and data-parallel
train step, head-TP and context-parallel decode, and `--mesh` for the
`train` and `serve` launchers, against the JAX package's mesh runs and
against the port's own one-process runs.

One spawn of eight gloo ranks (`test_torch_mesh.run_ranks`) computes every
case of the port (`_lm_mesh_rank`), and one subprocess at the same time
(eight emulated host devices, as `run_jax`) the JAX package's: the inputs of
`tests/test_sharded.py::test_cp_decode_equals_tp_decode` (reduced
granite-3-2b, f32, a (2, 4) mesh, B 4, cache 32) and of
`test_sharded_train_step_matches_single_device` (reduced qwen3-4b on
(2, 2, 2)), with the JAX package's initial weights loaded into the port's
mesh models (`convert.lm_params_from_numpy(mesh=)`).  Neither the ranks
nor this process import JAX.

The MoE block (experts over `model`) rides the same spawn and subprocess:
reduced(olmoe-1b-7b) from the JAX weights on (2, 4), one expert a rank
(prefill, "tp" / "cp" decode and caches), and its sharded step on
(2, 2, 2), at the JAX tests' bars; against the port's one process, the
ranks in two groups of four (reduced olmoe and the narrow config of
`tests/test_torch_moe.py`, E 64 top-8) on (2, 2) and (1, 4), every impl's
prefill (logits 1e-5, routing and drops identical), greedy tokens, the
capacity and ragged steps, error feedback, phi3.5-moe's reduced config,
(1, 8) (the axis does not divide E: experts whole), the replicated leaves
bit for bit equal over the model ranks after the steps, a (2, 2)
checkpoint onto (1, 2) and one process, and the launchers' `--mesh
single` for olmoe-1b-7b and phi3.5-moe.

The hybrid family (zamba2-7b's Mamba2 heads and its shared attention and
MLP block over `model`) rides them too: reduced(zamba2-7b) from the JAX
weights on (2, 4), two Mamba2 heads a rank (prefill, "tp" / "cp" decode,
the conv and ssm states and each shared application's keys and values),
and its sharded step on (2, 2, 2), at the JAX tests' bars; against the
port's one process, "tp" and "cp" serving on (2, 4), the steps on (2, 4)
(ZeRO-3) and (4, 2) (ZeRO-3 off, 2 microbatches), error feedback, a
narrow config whose H = 4 the (1, 8) axis does not divide (every head on
every rank, the split leaves gathered), the replicated leaves (gn,
dt_bias, the norms, the shared block's) bit for bit equal over the model
ranks, a (2, 4) checkpoint restored into one process, and both launchers'
`--mesh single`.

Bars.  Against the JAX package, its tests' own: CP and TP decode logits
2e-3 and caches 1e-4 (also CP against TP), the sharded step's loss 1e-4
and parameters 2e-4.  Against the port's one-process runs, in f32: greedy
tokens identical, decode and prefill logits 1e-5, per-step loss and grad
norm 1e-5 (relative), parameters after the steps 1e-5 (2e-4 with error
feedback, where a code one step off in the int8 quantization moves a
parameter by up to two learning rates of AdamW's first steps), a resumed
mesh run bit for bit the uninterrupted one, and every rank's results the
same.  The hybrid family's steps are held by `_assert_train_hybrid`'s
rule instead: its Mamba2 blocks amplify the mesh's other rounding into
gradients 1.5e-5 of a leaf's largest magnitude apart, which AdamW's first
steps turn into a move of up to a learning rate at a parameter whose
gradient is that close to zero.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import REPO, run_ranks  # noqa: E402

B, CL = 4, 32                       # the JAX test's decode batch and cache
STEPS = 2                           # train steps a port-vs-itself case runs
TOL_F32 = 1e-5
TOL_EF_PARAMS = 2e-4

# (name, arch, vocab or 0, mesh shape, axes, zero3, microbatches, compress)
TRAIN_CASES = [
    ("qwen_pod_data_model", "qwen3-4b", 0, (2, 2, 2),
     ("pod", "data", "model"), True, 1, False),
    ("granite_odd_vocab_zero3_off_micro2", "granite-3-2b", 129, (2, 4),
     ("data", "model"), False, 2, False),
    ("qwen_kv_undivided_ef", "qwen3-4b", 0, (2, 4), ("data", "model"),
     True, 1, True),
    ("qwen_ef_pod_model", "qwen3-4b", 0, (4, 2), ("pod", "model"),
     True, 2, True),
]
# (name, arch, vocab or 0, mesh shape, axes, zero3, decode mode, cache)
SERVE_CASES = [
    ("qwen_tp_kv_undivided", "qwen3-4b", 0, (2, 4), ("data", "model"),
     True, "tp", 16),
    ("qwen_cp_kv_undivided", "qwen3-4b", 0, (2, 4), ("data", "model"),
     True, "cp", 16),
    ("granite_odd_vocab_tp", "granite-3-2b", 129, (4, 2),
     ("data", "model"), False, "tp", 16),
    ("granite_odd_vocab_cp", "granite-3-2b", 129, (4, 2),
     ("data", "model"), False, "cp", 16),
    # 8 model ranks do not divide n_heads 4: every rank runs every head
    ("qwen_model8_cp", "qwen3-4b", 0, (1, 8), ("data", "model"), True,
     "cp", 16),
    # the model axis does not divide the cache: "cp" runs as "tp"
    ("qwen_cp_falls_back", "qwen3-4b", 0, (2, 4), ("data", "model"), True,
     "cp", 18),
]
OTHER_KINDS = ["xlstm-1.3b", "internvl2-2b", "seamless-m4t-medium"]
# The MoE block with its experts over the model axis.  The eight ranks run
# two (data, model) meshes of four side by side (a "rep" axis of 2 over
# them): group 0 reduced(olmoe-1b-7b) (E 4, top-2), group 1 the narrow
# config of tests/test_torch_moe.py (E 64, top-8), on (2, 2) and (1, 4) (at
# (1, 4) each rank of group 0 holds one expert); then all eight ranks on
# (1, 8), which does not divide E = 4 (every rank holds every expert).
MOE_CONFIGS = ["reduced", "narrow"]
MOE_MESHES = [(2, 2), (1, 4)]
MOE_IMPLS = ["capacity", "gather", "hybrid", "dense", "ragged"]
MOE_TRAIN_IMPLS = ["capacity", "ragged"]
MOE_S = 12                          # prefill length
MOE_SERVE = (3, 2, 3, 3)            # requests, slots, prompt, new tokens
# the launchers' --mesh single on the production mesh cut to (2, 4)
MOE_TRAIN_ARGV = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                  "--steps", "2", "--batch", "4", "--seq", "16",
                  "--log-every", "100"]
MOE_SERVE_ARGV = ["--arch", "phi3.5-moe", "--reduced", "--device", "cpu",
                  "--requests", "2", "--slots", "2", "--prompt-len", "3",
                  "--max-new", "2", "--cache-len", "16"]
# The hybrid family on the model axis: reduced(zamba2-7b) (H 8 Mamba2 heads
# of 16, the shared block's 4 heads) and its narrow variant (heads of 32:
# H = 4, which the (1, 8) axis does not divide).
# (name, mesh shape, axes, zero3, microbatches, compress)
HYB_TRAIN_CASES = [
    ("zero3_2x4", (2, 4), ("data", "model"), True, 1, False),
    ("zero3_off_micro2_4x2", (4, 2), ("data", "model"), False, 2, False),
    ("ef_2x4", (2, 4), ("data", "model"), True, 1, True),
    ("narrow_1x8", (1, 8), ("data", "model"), True, 1, False),
]
HYB_SERVE = (3, 2, 2, 2)            # requests, slots, prompt, new tokens
# The f32 gradients of the mesh against one process's, each leaf within
# this fraction of its largest magnitude (at most 1.53e-5 measured, where a
# mesh without a model axis stays within 7.1e-7): the Mamba2 blocks
# amplify the other rounding of the tensor-parallel sums.
HYB_GRAD_TOL = 1e-4
HYB_TRAIN_ARGV = ["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                  "--steps", "2", "--batch", "4", "--seq", "16",
                  "--log-every", "100"]
HYB_SERVE_ARGV = ["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                  "--requests", "2", "--slots", "2", "--prompt-len", "3",
                  "--max-new", "2", "--cache-len", "16", "--decode-mode",
                  "cp"]


# ---------------------------------------------------------------- the JAX side

_JAX = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS, TrainConfig, reduced
from repro.distributed.shardings import shard_ctx
from repro.launch.mesh import compat_mesh
from repro.models import build_model
from repro.training.step import make_train_step, train_state_init
from repro.data.tokens import TokenPipeline
import os
out = {}
def put(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            put(prefix + k + "/", v)
        else:
            out[prefix + k] = np.asarray(v, np.float32)
def save(path):    # whole or not at all: the ranks wait for it
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)
# the weights and inputs first
g_cfg = reduced(ARCHS["granite-3-2b"]).replace(dtype="float32")
g_m = build_model(g_cfg)
g_mesh = compat_mesh((2, 4), ("data", "model"))
rng = np.random.default_rng(0)
with shard_ctx(g_mesh), g_mesh:
    params = g_m.init(jax.random.key(0))
toks = jnp.asarray(rng.integers(0, g_cfg.vocab, (4, 1)), jnp.int32)
pos = jnp.asarray(rng.integers(4, 8, (4,)), jnp.int32)
o_cfg = reduced(ARCHS["olmoe-1b-7b"]).replace(dtype="float32")
o_m = build_model(o_cfg)
with shard_ctx(g_mesh), g_mesh:
    o_params = o_m.init(jax.random.key(1))
o_toks = jnp.asarray(rng.integers(0, o_cfg.vocab, (4, 12)), jnp.int32)
z_cfg = reduced(ARCHS["zamba2-7b"]).replace(dtype="float32")
z_m = build_model(z_cfg)
with shard_ctx(g_mesh), g_mesh:
    z_params = z_m.init(jax.random.key(2))
z_toks = jnp.asarray(rng.integers(0, z_cfg.vocab, (4, 12)), jnp.int32)
q_cfg = reduced(ARCHS["qwen3-4b"]).replace(dtype="float32")
q_m = build_model(q_cfg)
tcfg = TrainConfig()
batch = {k: jnp.asarray(v) for k, v in TokenPipeline(q_cfg.vocab, 8, 16,
                                                    seed=0).batch_at(0).items()}
state0 = train_state_init(q_m.init(jax.random.key(0)), tcfg)
put("granite/", params)
put("qwen/", state0.params)
put("olmoe/", o_params)
put("zamba2/", z_params)
out["moe_toks"] = np.asarray(o_toks)
out["hyb_toks"] = np.asarray(z_toks)
out["toks"], out["pos"] = np.asarray(toks), np.asarray(pos)
out["tokens"], out["labels"] = np.asarray(batch["tokens"]), np.asarray(batch["labels"])
save("{inputs}")
# test_cp_decode_equals_tp_decode
with shard_ctx(g_mesh), g_mesh:
    caches = g_m.init_cache(4, 32)
    lg_tp, c_tp = g_m.decode_step(params, caches, toks, pos, decode_mode="tp")
    lg_cp, c_cp = g_m.decode_step(params, caches, toks, pos, decode_mode="cp")
out["lg_tp"], out["lg_cp"] = np.asarray(lg_tp), np.asarray(lg_cp)
put("cache_tp/", c_tp)
put("cache_cp/", c_cp)
# the MoE block, experts over the model axis: prefill, then TP and CP decode
with shard_ctx(g_mesh), g_mesh:
    o_lg, _ = o_m.prefill(o_params, {"tokens": o_toks})
    o_caches = o_m.init_cache(4, 32)
    o_tp, oc_tp = o_m.decode_step(o_params, o_caches, toks, pos, "tp")
    o_cp, oc_cp = o_m.decode_step(o_params, o_caches, toks, pos, "cp")
out["moe_prefill"] = np.asarray(o_lg)
out["moe_lg_tp"], out["moe_lg_cp"] = np.asarray(o_tp), np.asarray(o_cp)
put("moe_cache_tp/", oc_tp)
put("moe_cache_cp/", oc_cp)
# the hybrid family, Mamba2 heads and the shared block over the model axis
# (jitted: op by op, its Mamba2 blocks' many small ops take 20 s more)
with shard_ctx(g_mesh), g_mesh:
    z_lg, _ = jax.jit(z_m.prefill)(z_params, {"tokens": z_toks})
    z_caches = z_m.init_cache(4, 32)
    z_dec = jax.jit(z_m.decode_step, static_argnums=4)
    z_tp, zc_tp = z_dec(z_params, z_caches, toks, pos, "tp")
    z_cp, zc_cp = z_dec(z_params, z_caches, toks, pos, "cp")
out["hyb_prefill"] = np.asarray(z_lg)
out["hyb_lg_tp"], out["hyb_lg_cp"] = np.asarray(z_tp), np.asarray(z_cp)
put("hyb_cache_tp/", zc_tp)
put("hyb_cache_cp/", zc_cp)
# test_sharded_train_step_matches_single_device
mesh = compat_mesh((2, 2, 2), ("pod", "data", "model"))
with shard_ctx(mesh), mesh:
    state1 = train_state_init(q_m.init(jax.random.key(0)), tcfg)
    s_sh, met = jax.jit(make_train_step(q_m, tcfg))(state1, batch)
out["train_loss"] = np.asarray(met["loss"])
put("trained/", s_sh.params)
with shard_ctx(mesh), mesh:
    o_state = train_state_init(o_m.init(jax.random.key(1)), tcfg)
    o_sh, o_met = jax.jit(make_train_step(o_m, tcfg))(o_state, batch)
out["moe_train_loss"] = np.asarray(o_met["loss"])
put("moe_trained/", o_sh.params)
with shard_ctx(mesh), mesh:
    z_state = train_state_init(z_m.init(jax.random.key(2)), tcfg)
    z_sh, z_met = jax.jit(make_train_step(z_m, tcfg))(z_state, batch)
out["hyb_train_loss"] = np.asarray(z_met["loss"])
put("hyb_trained/", z_sh.params)
save("{path}")
"""


def _nest(flat: dict, prefix: str) -> dict:
    """The nested dict of the `prefix/`-keyed arrays of an npz."""
    tree: dict = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        *outer, leaf = key[len(prefix):].split("/")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


def _leaves(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


# ------------------------------------------------------------- the port side

def _cfg(arch: str, vocab: int = 0):
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(arch)).replace(dtype="float32")
    return cfg.replace(vocab=vocab) if vocab else cfg


def _whole_caches(model, caches: dict, b: int, mode: str) -> dict:
    """A mesh model's cache blocks gathered whole, in the JAX layout
    ({"seg_00": {"k": (L, B, S, Hkv, hd), ...}})."""
    mp = model.mp
    cfg = model.cfg
    # a Mamba block's state: conv (B, w-1, d_inner), ssm (B, H, hd, N),
    # head-split in either mode where the axis divides H
    ssm_dim = {"conv": 2, "ssm": 1} if cfg.ssm_state and mp.splits(
        cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim) else {}
    out = {}
    for seg, layers in caches.items():
        whole = {}
        for name in layers[0]:
            ts = []
            for c in layers:
                t = c[name]
                if name in ("conv", "ssm"):
                    if name in ssm_dim:
                        t = mp.gather(t.contiguous(), ssm_dim[name])
                elif mode == "cp" and mp.size > 1:
                    t = mp.gather(t.contiguous(), 1)
                elif mp.splits(cfg.n_kv_heads):
                    t = mp.gather(t.contiguous(), 2)
                ts.append(mp.gather_rows(t, b).numpy())
            whole[name] = np.stack(ts)
        out[seg] = whole
    return out


def _serve(model, mode: str, cache_len: int = 16, sizes=(5, 3, 5, 4)):
    """`sizes` = (requests, slots, prompt, new tokens); by default five
    requests on three slots (recycling), prompt 5, 4 new tokens."""
    from repro_torch.serving.engine import Request, ServeEngine
    n, slots, prompt, new = sizes
    rng = np.random.default_rng(1)
    eng = ServeEngine(model, n_slots=slots, cache_len=cache_len,
                      decode_mode=mode)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab, prompt),
                    max_new=new) for i in range(n)]
    return sorted((r.uid, tuple(r.out)) for r in eng.run(reqs))


def _train(model, tcfg, steps: int = STEPS, states=None, grads: int = 0):
    """`steps` steps of a pipeline of 8 x 16: each step's (loss, grad norm,
    lr) and the parameters after them (JAX layout); the final state
    appended to `states` if given; the gradients of the first `grads`
    steps as AdamW takes them (JAX layout, whole)."""
    from repro_torch.convert import _to_jax_layout, train_state_to_numpy
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distributed.shardings import is_dtensor, like_dtensor
    from repro_torch.training import step as step_mod
    pipe = TokenPipeline(model.cfg.vocab, 8, 16, seed=0)
    st = step_mod.train_state_init({n: p.detach() for n, p in
                                    model.named_parameters()}, tcfg)
    step = step_mod.make_train_step(model, tcfg)
    update, seen = step_mod.adamw_update, []

    def recorded(params, g, *a, **kw):
        if len(seen) < grads:
            seen.append(dict(_leaves(_to_jax_layout({
                n: like_dtensor(t.contiguous(), st.params[n])
                if is_dtensor(st.params[n]) else t for n, t in g.items()}))))
        return update(params, g, *a, **kw)
    if grads:
        step_mod.adamw_update = recorded
    mets = []
    try:
        for i in range(steps):
            st, met = step(st, pipe.batch_at(i))
            mets.append([float(met[k]) for k in ("loss", "grad_norm", "lr")])
    finally:
        step_mod.adamw_update = update
    if states is not None:
        states.append(st)
    out = {"metrics": mets,
           "params": dict(_leaves(train_state_to_numpy(st).params))}
    if grads:
        out["grads"] = seen
    return out


def _moe_cfg(which: str, impl: str = "capacity"):
    """reduced(olmoe-1b-7b), its narrow variant (E 64, top-8) or
    reduced(phi3.5-moe), f32, with MoE impl `impl`."""
    import dataclasses
    cfg = _cfg("phi3.5-moe" if which == "phi" else "olmoe-1b-7b")
    moe = dataclasses.replace(cfg.moe, impl=impl)
    if which == "narrow":
        moe = dataclasses.replace(moe, n_experts=64, top_k=8)
    return cfg.replace(moe=moe)


class _Routes:
    """While active, the top-k ids of every call of the MoE router, in
    layer order (numpy)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.module, self.router, self.calls = moe, moe._router, []

        def recorded(p, x, cfg):
            top_p, top_i = self.router(p, x, cfg)
            self.calls.append(top_i.detach().numpy().copy())
            return top_p, top_i
        moe._router = recorded
        return self

    def __exit__(self, *exc):
        self.module._router = self.router
        return False


def _moe_batch(cfg):
    return {"tokens": np.random.default_rng(2).integers(0, cfg.vocab,
                                                        (B, MOE_S))}


def _moe_forward(model, serve_modes=()) -> dict:
    """The prefill's logits and every layer's routing (a mesh rank: of its
    rows, `rows`), and the slot engine's greedy tokens in each mode of
    `serve_modes` (`MOE_SERVE`)."""
    with _Routes() as r:
        logits = model.prefill(_moe_batch(model.cfg))[0].numpy()
    rows = (0, B) if model.mp is None else model.mp.rows(B)
    return {"prefill": logits, "routing": r.calls, "rows": rows,
            "tokens": {mode: _serve(model, mode, sizes=MOE_SERVE)
                       for mode in serve_modes}}


def _replicated(params: dict) -> dict:
    """name -> the bytes of this rank's block of each parameter that the
    model axis does not split."""
    out = {}
    for n, t in params.items():
        md = t.device_mesh.mesh_dim_names.index("model")
        if t.placements[md].is_replicate():
            out[n] = t.to_local().numpy().tobytes()
    return out


def _lm_mesh_moe(rank, mesh_of, ckpt_dir) -> dict:
    """This rank's MoE cases against one process (`MOE_CONFIGS` x
    `MOE_MESHES` in two groups of four ranks, then (1, 8)), and a (2, 2)
    checkpoint restored onto (1, 2)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.convert import (
        train_state_from_numpy, train_state_to_numpy,
    )
    from repro_torch.distributed.shardings import (
        ShardCtx, Sharding, param_specs, shard_ctx,
    )
    from repro_torch.models import build_model

    def sub(shape):     # this rank's (data, model) mesh of prod(shape)
        rep = 8 // (shape[0] * shape[1])
        return mesh_of((rep,) + shape, ("rep", "data", "model"))[
            "data", "model"]

    def on(cfg, mesh):
        with shard_ctx(mesh):
            return build_model(cfg, device="cpu", mesh=mesh).init(
                torch.Generator().manual_seed(0))
    tcfg = TrainConfig(warmup_steps=1, total_steps=4)
    group = rank // 4
    which = MOE_CONFIGS[group]
    out = {"which": which, "fwd": {}, "train": {}, "replicated": {},
           "coord": {}}
    for shape in MOE_MESHES:
        mesh = sub(shape)
        out["coord"][shape] = mesh.get_coordinate()
        for impl in MOE_IMPLS:
            out["fwd"][shape, impl] = _moe_forward(
                on(_moe_cfg(which, impl), mesh),
                ("tp", "cp") if impl == "capacity" else ())
        for impl in MOE_TRAIN_IMPLS:
            states = []
            out["train"][shape, impl] = _train(
                on(_moe_cfg(which, impl), mesh), tcfg, states=states)
            out["replicated"][shape, impl] = _replicated(states[0].params)
            if (shape, impl) == ((2, 2), "capacity"):
                trained = states[0]
    # error feedback on (2, 2): each expert leaf's amax over the whole leaf
    out["train_ef"] = _train(on(_moe_cfg(which), sub((2, 2))), TrainConfig(
        warmup_steps=1, total_steps=4, compress_cross_pod=True))
    # phi3.5-moe's reduced config on (2, 2): a prefill and a step
    out["phi_fwd"] = _moe_forward(on(_moe_cfg("phi"), sub((2, 2))),
                                  ("tp",))
    out["phi_train"] = _train(on(_moe_cfg("phi"), sub((2, 2))), tcfg,
                              steps=1)
    # (1, 8) does not divide E = 4: the experts are whole on every rank
    mesh = mesh_of((1, 8), ("data", "model"))
    m8 = on(_moe_cfg("reduced"), mesh)
    out["model8"] = {"fwd": _moe_forward(m8, ("cp",)), "experts": tuple(
        m8.segments["seg_00"][0]["we_g"].to_local().shape)}
    states = []
    out["model8"]["train"] = _train(on(_moe_cfg("reduced"), mesh), tcfg,
                                    states=states)
    out["model8"]["replicated"] = _replicated(states[0].params)
    # the trained (2, 2) capacity state saved, then restored onto (1, 2)
    cfg = _moe_cfg(which)
    mgr = CheckpointManager(os.path.join(ckpt_dir, f"moe_{group}"))
    mgr.save(1, trained.params)
    m12 = sub((1, 2))
    with shard_ctx(m12):
        mr = build_model(cfg, device="cpu", mesh=m12)
    named = dict(mr.named_parameters())
    specs = param_specs(named, ShardCtx(mesh=m12))
    _, back = mgr.restore(
        {n: trained.params[n] for n in named},
        shardings={n: Sharding(m12, specs[n]) for n in named}, device="cpu")
    with torch.no_grad():
        for n, p in named.items():
            p.to_local().copy_(back[n].to_local())
    out["restored_1x2"] = mr.prefill(_moe_batch(cfg))[0].numpy()
    # the same state through the JAX layout onto (1, 2)
    tree = train_state_to_numpy(trained)
    with shard_ctx(m12):
        st12 = train_state_from_numpy(tree, cfg, device="cpu", mesh=m12)
    out["from_numpy_1x2"] = all(
        torch.equal(st12.params[n].to_local(), back[n].to_local())
        and st12.params[n].placements == back[n].placements
        and st12.opt.mu[n].placements == back[n].placements
        for n in named)
    return out


def _hyb_cfg(narrow: bool = False):
    """reduced(zamba2-7b) in f32; `narrow`: Mamba2 heads of 32 (H = 4)."""
    cfg = _cfg("zamba2-7b")
    return cfg.replace(ssm_head_dim=32) if narrow else cfg


def _hyb_batch(cfg):
    return {"tokens": np.random.default_rng(2).integers(0, cfg.vocab,
                                                        (B, MOE_S))}


def _hyb_forward(model) -> dict:
    """The prefill's logits and the slot engine's greedy tokens in "tp"
    and "cp" (`HYB_SERVE`, cache 16)."""
    return {"prefill": model.prefill(_hyb_batch(model.cfg))[0].numpy(),
            "layout": model.decode_layout(16, "cp"),
            "tokens": {mode: _serve(model, mode, sizes=HYB_SERVE)
                       for mode in ("tp", "cp")}}


def _lm_mesh_hybrid(rank, mesh_of, ckpt_dir) -> dict:
    """This rank's hybrid cases against one process: serving on (2, 4) and
    on (1, 8) (the narrow config), the `HYB_TRAIN_CASES` steps with their
    gradients and replicated leaves, and the trained (2, 4) state saved
    for a one-process restore."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed.shardings import shard_ctx
    from repro_torch.models import build_model

    def on(cfg, mesh, zero3=True):
        with shard_ctx(mesh, zero3=zero3):
            return build_model(cfg, device="cpu", mesh=mesh).init(
                torch.Generator().manual_seed(0))
    out = {"fwd": {}, "train": {}, "replicated": {}, "coord": {}}
    # full width on the meta device: this rank's blocks of a Mamba2 layer
    # and of the shared block
    from repro_torch.configs import get_arch
    with shard_ctx(mesh_of((2, 4), ("data", "model"))):
        mf = build_model(get_arch("zamba2-7b"), device="meta",
                         mesh=mesh_of((2, 4), ("data", "model")))
    layer = mf.segments["seg_00"][0]
    out["full_width"] = {n: tuple(layer[n].to_local().shape)
                         for n in layer.keys()}
    out["full_width"]["shared.wq"] = tuple(mf.shared["wq"].to_local().shape)
    del mf, layer
    m = on(_hyb_cfg(), mesh_of((2, 4), ("data", "model")))
    out["mamba_in_w"] = tuple(m.segments["seg_00"][0]["in_w"]
                              .to_local().shape)
    out["fwd"]["2x4"] = _hyb_forward(m)
    m8 = on(_hyb_cfg(narrow=True), mesh_of((1, 8), ("data", "model")))
    out["fwd"]["narrow_1x8"] = _hyb_forward(m8)
    out["narrow_in_w"] = tuple(m8.segments["seg_00"][0]["in_w"]
                               .to_local().shape)
    for name, shape, axes, zero3, micro, ef in HYB_TRAIN_CASES:
        mesh = mesh_of(shape, axes)
        m = on(_hyb_cfg(narrow=name.startswith("narrow")), mesh, zero3)
        states = []
        out["train"][name] = _train(m, TrainConfig(
            warmup_steps=1, total_steps=4, microbatches=micro,
            compress_cross_pod=ef), states=states, grads=1)
        out["replicated"][name] = _replicated(states[0].params)
        out["coord"][name] = mesh.get_coordinate()
        if name == "zero3_2x4":
            CheckpointManager(os.path.join(ckpt_dir, "hybrid")).save(
                1, states[0].params)
            out["trained_prefill"] = m.prefill(_hyb_batch(m.cfg))[0].numpy()
    return out


def _lm_mesh_rank(rank, world, jax_npz, ckpt_dir):
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig
    from repro_torch.convert import lm_params_from_numpy, train_state_to_numpy
    from repro_torch.distributed.shardings import shard_ctx
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.models import build_model
    from repro_torch.training.step import make_train_step, train_state_init

    meshes = {}

    def mesh_of(shape, axes):       # each mesh's groups made once
        if (shape, axes) not in meshes:
            meshes[shape, axes] = compat_mesh(shape, axes, device_type="cpu")
        return meshes[shape, axes]

    def one(cfg):
        return build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))

    def on_mesh(cfg, mesh, zero3):
        with shard_ctx(mesh, zero3=zero3):
            return build_model(cfg, device="cpu", mesh=mesh).init(
                torch.Generator().manual_seed(0))

    out = {"rank": rank}

    # -- the port against its one-process runs
    out["serve"] = {}
    for name, arch, vocab, shape, axes, zero3, mode, cache in SERVE_CASES:
        cfg = _cfg(arch, vocab)
        mm = on_mesh(cfg, mesh_of(shape, axes), zero3)
        batch = {"tokens": np.random.default_rng(2).integers(
            0, cfg.vocab, (B, 12))}
        prefill = mm.prefill(batch)[0].numpy()
        out["serve"][name] = {"tokens": _serve(mm, mode, cache),
                              "layout": mm.decode_layout(cache, mode),
                              "prefill": prefill}
    out["train"] = {}
    for name, arch, vocab, shape, axes, zero3, micro, ef in TRAIN_CASES:
        tcfg = TrainConfig(warmup_steps=1, total_steps=4,
                           microbatches=micro, compress_cross_pod=ef)
        mm = on_mesh(_cfg(arch, vocab), mesh_of(shape, axes), zero3)
        out["train"][name] = _train(mm, tcfg)

    out["moe"] = _lm_mesh_moe(rank, mesh_of, ckpt_dir)
    out["hybrid"] = _lm_mesh_hybrid(rank, mesh_of, ckpt_dir)

    # -- other kinds and the dry run's levers raise on a model axis
    mesh = mesh_of((2, 4), ("data", "model"))
    out["raises"] = {}
    for arch in OTHER_KINDS:
        try:
            on_mesh(_cfg(arch), mesh, True)
            out["raises"][arch] = None
        except NotImplementedError as e:
            out["raises"][arch] = str(e)
    for lever in ({"seq_shard_acts": True}, {"force_decode_mode": "cp"}):
        with shard_ctx(mesh, **lever):
            try:
                build_model(_cfg("qwen3-4b"), device="cpu", mesh=mesh)
                out["raises"][str(lever)] = None
            except NotImplementedError as e:
                out["raises"][str(lever)] = str(e)
    # a data-only mesh runs any kind: zamba2's hybrid blocks on (8,)
    out["zamba2_data_only"] = _train(on_mesh(
        _cfg("zamba2-7b"), mesh_of((8,), ("data",)), True),
        TrainConfig(warmup_steps=1, total_steps=4), steps=1)

    # -- the JAX package's weights, once its subprocess has written them
    deadline = time.monotonic() + 240
    while not os.path.exists(jax_npz):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {jax_npz}")
        time.sleep(0.2)
    jx = dict(np.load(jax_npz))

    # -- the JAX test's decode: TP and CP on (2, 4) from the JAX weights
    mesh = mesh_of((2, 4), ("data", "model"))
    cfg = _cfg("granite-3-2b")
    with shard_ctx(mesh):
        m = lm_params_from_numpy(_nest(jx, "granite/"), cfg, device="cpu",
                                 mesh=mesh)
    for mode in ("tp", "cp"):
        caches = m.init_cache(B, CL, mode)
        lg, caches = m.decode_step(caches, jx["toks"], jx["pos"],
                                   decode_mode=mode)
        out[f"lg_{mode}"] = lg.numpy()
        out[f"cache_{mode}"] = dict(_leaves(_whole_caches(m, caches, B,
                                                          mode)))

    # -- the MoE block from the JAX weights on (2, 4): one expert a rank
    cfg = _moe_cfg("reduced")
    with shard_ctx(mesh):
        mo = lm_params_from_numpy(_nest(jx, "olmoe/"), cfg, device="cpu",
                                  mesh=mesh)
    out["moe_experts"] = tuple(mo.segments["seg_00"][0]["we_g"]
                               .to_local().shape)
    out["moe_prefill"] = mo.prefill({"tokens": jx["moe_toks"]})[0].numpy()
    for mode in ("tp", "cp"):
        caches = mo.init_cache(B, CL, mode)
        lg, caches = mo.decode_step(caches, jx["toks"], jx["pos"],
                                    decode_mode=mode)
        out[f"moe_lg_{mode}"] = lg.numpy()
        out[f"moe_cache_{mode}"] = dict(_leaves(_whole_caches(
            mo, caches, B, mode)))

    # -- the hybrid family from the JAX weights on (2, 4): two heads a rank
    with shard_ctx(mesh):
        mz = lm_params_from_numpy(_nest(jx, "zamba2/"), _hyb_cfg(),
                                  device="cpu", mesh=mesh)
    out["hyb_prefill"] = mz.prefill({"tokens": jx["hyb_toks"]})[0].numpy()
    for mode in ("tp", "cp"):
        caches = mz.init_cache(B, CL, mode)
        lg, caches = mz.decode_step(caches, jx["toks"], jx["pos"],
                                    decode_mode=mode)
        out[f"hyb_lg_{mode}"] = lg.numpy()
        out[f"hyb_cache_{mode}"] = dict(_leaves(_whole_caches(
            mz, caches, B, mode)))

    # -- the JAX test's sharded step on (2, 2, 2) from the JAX weights
    mesh = mesh_of((2, 2, 2), ("pod", "data", "model"))
    cfg = _cfg("qwen3-4b")
    with shard_ctx(mesh):
        mq = lm_params_from_numpy(_nest(jx, "qwen/"), cfg, device="cpu",
                                  mesh=mesh)
    st = train_state_init({n: p.detach() for n, p in mq.named_parameters()},
                          TrainConfig())
    st, met = make_train_step(mq, TrainConfig())(
        st, {"tokens": jx["tokens"], "labels": jx["labels"]})
    out["train_loss"] = float(met["loss"])
    out["trained"] = dict(_leaves(train_state_to_numpy(st).params))
    with shard_ctx(mesh):
        mo = lm_params_from_numpy(_nest(jx, "olmoe/"), _moe_cfg("reduced"),
                                  device="cpu", mesh=mesh)
    so = train_state_init({n: p.detach() for n, p in
                           mo.named_parameters()}, TrainConfig())
    so, met = make_train_step(mo, TrainConfig())(
        so, {"tokens": jx["tokens"], "labels": jx["labels"]})
    out["moe_train_loss"] = float(met["loss"])
    out["moe_trained"] = dict(_leaves(train_state_to_numpy(so).params))
    with shard_ctx(mesh):
        mz = lm_params_from_numpy(_nest(jx, "zamba2/"), _hyb_cfg(),
                                  device="cpu", mesh=mesh)
    sz = train_state_init({n: p.detach() for n, p in
                           mz.named_parameters()}, TrainConfig())
    sz, met = make_train_step(mz, TrainConfig())(
        sz, {"tokens": jx["tokens"], "labels": jx["labels"]})
    out["hyb_train_loss"] = float(met["loss"])
    out["hyb_trained"] = dict(_leaves(train_state_to_numpy(sz).params))
    # the DTensor blocks through CheckpointManager.save / restore(shardings=)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.shardings import (
        ShardCtx, Sharding, param_specs,
    )
    mgr = CheckpointManager(os.path.join(ckpt_dir, "dtensor"))
    mgr.save(1, st.params)
    specs = param_specs(st.params, ShardCtx(mesh=mesh))
    _, back = mgr.restore(st.params, shardings={
        n: Sharding(mesh, spec) for n, spec in specs.items()}, device="cpu")
    out["dtensor_roundtrip"] = all(
        torch.equal(back[n].to_local(), t.to_local())
        and back[n].placements == t.placements
        for n, t in st.params.items())

    # -- the launchers' --mesh single, the production mesh cut to (2, 4)
    def small_mesh(multi_pod=False, device_type="cuda"):
        return mesh_of((2, 4), ("data", "model"))
    serve_launch.make_production_mesh = small_mesh
    train_launch.make_production_mesh = small_mesh
    serve_argv = ["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--prompt-len", "4",
                  "--max-new", "3", "--cache-len", "16"]
    out["serve_launch"] = [
        sorted((r.uid, tuple(r.out)) for r in serve_launch.main(
            serve_argv + ["--mesh", "single", "--decode-mode", mode]))
        for mode in ("tp", "cp")]
    out["moe_launch"] = {
        "train": train_launch.main(MOE_TRAIN_ARGV + ["--mesh", "single"]),
        "serve": sorted((r.uid, tuple(r.out)) for r in serve_launch.main(
            MOE_SERVE_ARGV + ["--mesh", "single"]))}
    out["hyb_launch"] = {
        "train": train_launch.main(HYB_TRAIN_ARGV + ["--mesh", "single"]),
        "serve": sorted((r.uid, tuple(r.out)) for r in serve_launch.main(
            HYB_SERVE_ARGV + ["--mesh", "single"]))}
    train_argv = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                  "--steps", "4", "--batch", "4", "--seq", "16",
                  "--mesh", "single", "--log-every", "100"]
    whole = os.path.join(ckpt_dir, "whole")
    cut = os.path.join(ckpt_dir, "cut")
    out["train_launch"] = train_launch.main(
        train_argv + ["--ckpt-dir", whole, "--ckpt-every", "2"])
    if rank == 0:   # interrupt the same run after step 2
        import shutil
        shutil.copytree(whole, cut)
        shutil.rmtree(os.path.join(cut, "step_00000004"))
    dist.barrier()
    out["resumed_launch"] = train_launch.main(
        train_argv + ["--ckpt-dir", cut, "--resume"])
    return out


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's runs in a subprocess of 8 emulated devices (as
    `run_jax`), started first; the 8 ranks meanwhile, which read its
    weights once it has written them."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inputs, npz = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    script = _JAX.replace("{path}", npz).replace("{inputs}", inputs)
    with subprocess.Popen([sys.executable, "-c", script], env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True) as jax_proc:
        try:
            ranks = run_ranks(_lm_mesh_rank, 8, inputs, str(tmp / "ckpt"),
                              timeout=240)
            _, err = jax_proc.communicate(timeout=240)
        finally:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    return {"jax": dict(np.load(npz)), "ranks": ranks, "tmp": tmp}


def _one_process_serve(arch, vocab, mode, cache):
    from repro_torch.models import build_model
    cfg = _cfg(arch, vocab)
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {"tokens": np.random.default_rng(2).integers(0, cfg.vocab,
                                                         (B, 12))}
    return {"tokens": _serve(m, mode, cache),
            "prefill": m.prefill(batch)[0].numpy()}


# ------------------------------------------------------- against the JAX side

@pytest.mark.parametrize("mode", ["tp", "cp"])
def test_decode_logits_and_caches_equal_jax(runs, mode):
    jx, r0 = runs["jax"], runs["ranks"][0]
    np.testing.assert_allclose(r0[f"lg_{mode}"], jx[f"lg_{mode}"],
                               atol=2e-3)
    caches = _nest(jx, f"cache_{mode}/")
    for name, want in _leaves(caches):
        np.testing.assert_allclose(r0[f"cache_{mode}"][name], want,
                                   atol=1e-4, err_msg=name)


def test_cp_decode_equals_tp_decode(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["lg_cp"], r["lg_tp"], atol=2e-3)
        for name, a in r["cache_tp"].items():
            np.testing.assert_allclose(r["cache_cp"][name], a, atol=1e-4)
        assert np.array_equal(r["lg_tp"], runs["ranks"][0]["lg_tp"])


def test_mesh_state_checkpoint_restores_dtensor_blocks(runs):
    """The step's DTensor parameters saved by `CheckpointManager.save` (a
    collective of the mesh) and restored with `restore(shardings=)` from
    `param_specs`: every rank's blocks and placements back bit for bit."""
    assert [r["dtensor_roundtrip"] for r in runs["ranks"]] == [True] * 8


def test_sharded_train_step_equals_jax(runs):
    jx = runs["jax"]
    trained = dict(_leaves(_nest(jx, "trained/")))
    for r in runs["ranks"]:
        assert abs(r["train_loss"] - float(jx["train_loss"])) < 1e-4
        assert set(r["trained"]) == set(trained)
        for name, want in trained.items():
            np.testing.assert_allclose(r["trained"][name], want, atol=2e-4,
                                       err_msg=name)


# ------------------------------------------------ against the port itself

@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: c[0])
def test_mesh_serving_equals_one_process(runs, case):
    name, arch, vocab, shape, _, _, mode, cache = case
    want = _one_process_serve(arch, vocab, mode, cache)
    layout = "cp" if mode == "cp" and cache % shape[-1] == 0 else "tp"
    for r in runs["ranks"]:
        got = r["serve"][name]
        assert got["layout"] == layout
        assert got["tokens"] == want["tokens"]
        np.testing.assert_allclose(got["prefill"], want["prefill"],
                                   atol=TOL_F32)


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: c[0])
def test_mesh_train_steps_equal_one_process(runs, case):
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    name, arch, vocab, _, _, _, micro, ef = case
    cfg = _cfg(arch, vocab)
    want = _train(build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)),
        TrainConfig(warmup_steps=1, total_steps=4, microbatches=micro,
                    compress_cross_pod=ef))
    tol = TOL_EF_PARAMS if ef else TOL_F32
    for r in runs["ranks"]:
        got = r["train"][name]
        assert got["metrics"] == runs["ranks"][0]["train"][name]["metrics"]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=TOL_F32)
        for leaf, a in want["params"].items():
            np.testing.assert_allclose(got["params"][leaf], a, atol=tol,
                                       err_msg=leaf)


def test_data_only_mesh_runs_other_kinds(runs):
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    want = _train(build_model(_cfg("zamba2-7b"), device="cpu").init(
        torch.Generator().manual_seed(0)),
        TrainConfig(warmup_steps=1, total_steps=4), steps=1)
    got = runs["ranks"][0]["zamba2_data_only"]
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=TOL_F32)
    for leaf, a in want["params"].items():
        np.testing.assert_allclose(got["params"][leaf], a, atol=TOL_F32)


@pytest.mark.parametrize("what", OTHER_KINDS + [
    str({"seq_shard_acts": True}), str({"force_decode_mode": "cp"})])
def test_unported_mesh_parts_raise(runs, what):
    for r in runs["ranks"]:
        assert r["raises"][what] is not None, what
        assert "multi-card" in r["raises"][what]


@pytest.mark.parametrize("mode", ["tp", "cp"])
def test_serve_launcher_mesh_single(runs, mode):
    from repro_torch.launch.serve import main
    want = main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--prompt-len", "4",
                 "--max-new", "3", "--cache-len", "16",
                 "--decode-mode", mode])
    want = sorted((r.uid, tuple(r.out)) for r in want)
    for r in runs["ranks"]:
        assert r["serve_launch"][["tp", "cp"].index(mode)] == want


def test_train_launcher_mesh_single_and_resume_bitwise(runs):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main
    tmp = runs["tmp"]
    want = main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                 "--steps", "4", "--batch", "4", "--seq", "16",
                 "--log-every", "100"])
    losses = {r["train_launch"] for r in runs["ranks"]}
    assert len(losses) == 1 and abs(losses.pop() - want) < TOL_F32
    assert {r["resumed_launch"] for r in runs["ranks"]} == \
        {runs["ranks"][0]["train_launch"]}
    whole = CheckpointManager(str(tmp / "ckpt" / "whole"))
    cut = CheckpointManager(str(tmp / "ckpt" / "cut"))
    assert whole.latest_step() == cut.latest_step() == 4
    a = np.load(os.path.join(whole.dir, "step_00000004", "shards.npz"))
    b = np.load(os.path.join(cut.dir, "step_00000004", "shards.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert json.dumps(whole.manifest(4)["leaves"]) == \
        json.dumps(cut.manifest(4)["leaves"])


# ------------------------------------------- the MoE block on a model axis

_ONE: dict = {}


@contextlib.contextmanager
def _one_thread():
    """One torch thread, as each rank runs: the suite's workers share the
    machine's cores, and on a thread pool they oversubscribe a tiny
    model's ops take many times as long."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _once(key, fn):
    """fn() of one process's references, once a key, on one thread."""
    if key not in _ONE:
        with _one_thread():
            _ONE[key] = fn()
    return _ONE[key]


def _moe_one(which: str, impl: str = "capacity") -> dict:
    """One process's `_moe_forward` (both modes) of a config."""
    from repro_torch.models import build_model

    def run():
        return _moe_forward(build_model(_moe_cfg(which, impl),
                                        device="cpu").init(
            torch.Generator().manual_seed(0)), ("tp", "cp"))
    return _once(("forward", which, impl), run)


def _moe_one_train(which: str, impl: str = "capacity", steps: int = STEPS,
                   ef: bool = False):
    """One process's `_train` of a config (error feedback if `ef`)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model

    def run():
        return _train(build_model(_moe_cfg(which, impl), device="cpu").init(
            torch.Generator().manual_seed(0)), TrainConfig(
            warmup_steps=1, total_steps=4, compress_cross_pod=ef),
            steps=steps)
    return _once(("train", which, impl, steps, ef), run)


def _moe_group(runs, which: str) -> list:
    return [r["moe"] for r in runs["ranks"] if r["moe"]["which"] == which]


def _drops(cfg, top_i: np.ndarray) -> list:
    """Each row's (token, choice) pairs past their expert's capacity."""
    from repro_torch.models import moe
    ti = torch.from_numpy(top_i)
    hit = moe._capacity_slots(torch.zeros(ti.shape), ti, cfg.moe.n_experts,
                              moe.capacity(cfg, ti.shape[1]))[1]
    return [int(ti[b].numel() - hit[b].sum()) for b in range(len(ti))]


def _assert_forward(got: dict, want: dict, cfg) -> None:
    """Logits within 1e-5, every layer's routing and drops of the rank's
    rows identical, greedy tokens identical."""
    lo, hi = got["rows"]
    np.testing.assert_allclose(got["prefill"], want["prefill"], atol=TOL_F32)
    assert len(got["routing"]) == len(want["routing"]) == cfg.n_layers
    for a, b in zip(got["routing"], want["routing"]):
        assert np.array_equal(a, b[lo:hi])
        assert _drops(cfg, a) == _drops(cfg, b)[lo:hi]
    for mode, tokens in got["tokens"].items():
        assert tokens == want["tokens"][mode], mode


def _assert_train(got: dict, want: dict, first: dict) -> None:
    assert got["metrics"] == first["metrics"]
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=TOL_F32)
    assert set(got["params"]) == set(want["params"])
    for leaf, a in want["params"].items():
        np.testing.assert_allclose(got["params"][leaf], a, atol=TOL_F32,
                                   err_msg=leaf)


def _assert_replicated_equal(blocks: list, coords: list,
                             among=(".router", ".norm2")) -> None:
    """Ranks at one data coordinate hold bit-identical blocks of every
    leaf the model axis does not split (the leaves named by the suffixes
    `among` among them)."""
    by_data: dict = {}
    for b, c in zip(blocks, coords):
        by_data.setdefault(c[0], []).append(b)
    for same in by_data.values():
        assert len(same) > 1
        for leaf in among:
            assert any(n.endswith(leaf) for n in same[0]), leaf
        for b in same[1:]:
            assert b.keys() == same[0].keys()
            for n in b:
                assert b[n] == same[0][n], n


def test_moe_experts_split_over_model_equal_jax_prefill(runs):
    """reduced(olmoe-1b-7b) on (2, 4): each rank holds one of the 4
    experts (d split over data by ZeRO-3), and the prefill's logits equal
    the JAX package's GSPMD run on the same weights."""
    jx = runs["jax"]
    for r in runs["ranks"]:
        assert r["moe_experts"] == (1, 32, 128)
        np.testing.assert_allclose(r["moe_prefill"], jx["moe_prefill"],
                                   atol=2e-3)


@pytest.mark.parametrize("mode", ["tp", "cp"])
def test_moe_decode_logits_and_caches_equal_jax(runs, mode):
    jx = runs["jax"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"moe_lg_{mode}"], jx[f"moe_lg_{mode}"],
                                   atol=2e-3)
    caches = _nest(jx, f"moe_cache_{mode}/")
    for name, want in _leaves(caches):
        np.testing.assert_allclose(runs["ranks"][0][f"moe_cache_{mode}"][name],
                                   want, atol=1e-4, err_msg=name)


def test_moe_sharded_train_step_equals_jax(runs):
    jx = runs["jax"]
    trained = dict(_leaves(_nest(jx, "moe_trained/")))
    for r in runs["ranks"]:
        assert abs(r["moe_train_loss"] - float(jx["moe_train_loss"])) < 1e-4
        assert set(r["moe_trained"]) == set(trained)
        for name, want in trained.items():
            np.testing.assert_allclose(r["moe_trained"][name], want,
                                       atol=2e-4, err_msg=name)


@pytest.mark.parametrize("impl", MOE_IMPLS)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("which", MOE_CONFIGS)
def test_moe_mesh_forward_equals_one_process(runs, which, shape, impl):
    want = _moe_one(which, impl)
    for got in _moe_group(runs, which):
        _assert_forward(got["fwd"][shape, impl], want, _moe_cfg(which, impl))


@pytest.mark.parametrize("impl", MOE_TRAIN_IMPLS)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("which", MOE_CONFIGS)
def test_moe_mesh_train_steps_equal_one_process(runs, which, shape, impl):
    want = _moe_one_train(which, impl)
    group = _moe_group(runs, which)
    for got in group:
        _assert_train(got["train"][shape, impl], want,
                      group[0]["train"][shape, impl])


@pytest.mark.parametrize("impl", MOE_TRAIN_IMPLS)
@pytest.mark.parametrize("shape", MOE_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("which", MOE_CONFIGS)
def test_moe_replicated_leaves_bitwise_equal_over_model(runs, which, shape,
                                                        impl):
    """After the steps, the model ranks of each data coordinate hold the
    same router, norms and every other leaf the model axis does not split,
    bit for bit: the router's gradient sums every rank's experts."""
    group = _moe_group(runs, which)
    _assert_replicated_equal([g["replicated"][shape, impl] for g in group],
                             [g["coord"][shape] for g in group])


@pytest.mark.parametrize("which", MOE_CONFIGS)
def test_moe_mesh_error_feedback_steps_equal_one_process(runs, which):
    """The steps with error feedback on (2, 2): the int8 quantization
    takes each expert leaf's amax over the whole leaf (both ranks'
    experts), so loss and grad norm are one process's within 1e-5.  A
    parameter whose gradient lies on a rounding boundary of the int8 code
    may take the next code on the mesh (its f32 sums run in another
    order), which moves it by at most two learning rates over AdamW's
    first two steps: the narrow config's 1,048,576-element expert leaves
    hold such an element (one, 3.8e-4 off), so the parameters' bar is two
    learning rates."""
    from repro_torch.configs import TrainConfig
    want = _moe_one_train(which, ef=True)
    lr = TrainConfig().learning_rate
    group = _moe_group(runs, which)
    for got in group:
        got = got["train_ef"]
        assert got["metrics"] == group[0]["train_ef"]["metrics"]
        np.testing.assert_allclose(got["metrics"], want["metrics"],
                                   rtol=TOL_F32)
        for leaf, a in want["params"].items():
            np.testing.assert_allclose(got["params"][leaf], a,
                                       atol=2 * lr, err_msg=leaf)


def test_moe_model_axis_not_dividing_experts_runs_them_whole(runs):
    """(1, 8) does not divide E = 4: every rank holds all four experts and
    its results equal one process's; after the steps every leaf, the
    experts too, is bit for bit the same on the eight ranks."""
    cfg = _moe_cfg("reduced")
    want_train = _moe_one_train("reduced")
    first = runs["ranks"][0]["moe"]["model8"]
    for r in runs["ranks"]:
        got = r["moe"]["model8"]
        assert got["experts"] == (cfg.moe.n_experts, cfg.d_model, cfg.d_ff)
        _assert_forward(got["fwd"], _moe_one("reduced"), cfg)
        _assert_train(got["train"], want_train, first["train"])
        assert any(n.endswith(".we_g") for n in got["replicated"])
    _assert_replicated_equal(
        [r["moe"]["model8"]["replicated"] for r in runs["ranks"]],
        [(0, r["rank"]) for r in runs["ranks"]])


def test_moe_phi_on_model_axis_equals_one_process(runs):
    """reduced(phi3.5-moe) on (2, 2): prefill, routing, greedy tokens and
    one step against one process."""
    cfg = _moe_cfg("phi")
    want = _moe_one("phi")
    want_train = _moe_one_train("phi", steps=1)
    first = runs["ranks"][0]["moe"]["phi_train"]
    for r in runs["ranks"]:
        _assert_forward(r["moe"]["phi_fwd"], want, cfg)
        _assert_train(r["moe"]["phi_train"], want_train, first)


@pytest.mark.parametrize("which", MOE_CONFIGS)
def test_moe_checkpoint_restores_onto_smaller_mesh_and_one_process(runs,
                                                                  which):
    """A trained (2, 2) state saved by `CheckpointManager` (a collective
    of its mesh), restored with `restore(shardings=)` onto (1, 2) and
    without shardings into one process: the one-process parameters are
    the mesh's trained ones bit for bit, both restored models' prefill
    logits agree, and the state carried through the JAX layout
    (`convert.train_state_from_numpy(mesh=)`) onto (1, 2) holds the same
    blocks."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import _to_jax_layout
    from repro_torch.models import build_model
    cfg = _moe_cfg(which)
    m = build_model(cfg, device="cpu")
    named = dict(m.named_parameters())
    mgr = CheckpointManager(str(runs["tmp"] / "ckpt" /
                                f"moe_{MOE_CONFIGS.index(which)}"))
    _, back = mgr.restore(named, device="cpu")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(back[n])
    with _one_thread():
        want = m.prefill(_moe_batch(cfg))[0].numpy()
    group = _moe_group(runs, which)
    trained = group[0]["train"][(2, 2), "capacity"]["params"]
    restored = dict(_leaves(_to_jax_layout(back)))
    assert set(restored) == set(trained)
    for leaf, a in trained.items():
        assert restored[leaf].tobytes() == a.tobytes(), leaf
    for got in group:
        np.testing.assert_allclose(got["restored_1x2"], want, atol=TOL_F32)
        assert got["from_numpy_1x2"]


def test_launchers_mesh_single_run_moe(runs):
    """`launch.train --arch olmoe-1b-7b --mesh single` and `launch.serve
    --arch phi3.5-moe --mesh single` on (2, 4) (one expert a rank): the
    final loss and the tokens of one process's launchers."""
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    with _one_thread():
        loss = train(MOE_TRAIN_ARGV)
        tokens = sorted((r.uid, tuple(r.out)) for r in serve(MOE_SERVE_ARGV))
    for r in runs["ranks"]:
        assert abs(r["moe_launch"]["train"] - loss) < TOL_F32
        assert r["moe_launch"]["serve"] == tokens


# ----------------------------------------- the hybrid family on a model axis

def _hyb_one(narrow: bool = False) -> dict:
    """One process's `_hyb_forward` of reduced zamba2-7b (or the narrow
    config)."""
    from repro_torch.models import build_model
    return _once(("hybrid_forward", narrow), lambda: _hyb_forward(
        build_model(_hyb_cfg(narrow), device="cpu").init(
            torch.Generator().manual_seed(0))))


def _hyb_one_train(case) -> dict:
    """One process's `_train` (with the gradients) of a HYB_TRAIN_CASES
    case."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    name, _, _, _, micro, ef = case
    return _once(("hybrid_train", name), lambda: _train(
        build_model(_hyb_cfg(name.startswith("narrow")), device="cpu").init(
            torch.Generator().manual_seed(0)), TrainConfig(
            warmup_steps=1, total_steps=4, microbatches=micro,
            compress_cross_pod=ef), grads=STEPS))


def _assert_train_hybrid(got: dict, want: dict, first: dict,
                         ef: bool) -> None:
    """The hybrid family's steps against one process's.  Every rank's
    metrics are rank 0's; every step's loss within 1e-5; the first step's
    grad norm within 1e-5 and its gradients each within HYB_GRAD_TOL of
    the leaf's largest magnitude (with error feedback, plus one int8 code,
    a 127th of it: a gradient on a code's rounding boundary may take the
    next code on the mesh); the later steps' grad norms (and error
    feedback's) within 1e-3.  Each parameter within 1e-5 (TOL_EF_PARAMS
    with error feedback), except where one process's gradient at some step
    lies within HYB_GRAD_TOL of the leaf's largest magnitude of zero: AdamW
    moves such a parameter by up to a learning rate a step whatever the
    size of its gradient, so the gradients' f32 noise sets its sign, and it
    is held within two learning rates a step."""
    from repro_torch.configs import TrainConfig
    assert got["metrics"] == first["metrics"]
    gm, wm = np.asarray(got["metrics"]), np.asarray(want["metrics"])
    np.testing.assert_allclose(gm[:, 0], wm[:, 0], rtol=TOL_F32)
    np.testing.assert_allclose(gm[0, 1], wm[0, 1],
                               rtol=1e-3 if ef else TOL_F32)
    np.testing.assert_allclose(gm[1:, 1], wm[1:, 1], rtol=1e-3)
    g0, w0 = got["grads"][0], want["grads"][0]
    assert set(g0) == set(w0) == set(want["params"])
    for leaf, a in w0.items():
        scale = float(np.abs(a).max())
        tol = HYB_GRAD_TOL + (1 / 127 if ef else 0.0)
        np.testing.assert_allclose(g0[leaf], a, atol=tol * scale,
                                   err_msg=leaf)
    lr = TrainConfig().learning_rate
    steps = len(want["metrics"])
    for leaf, a in want["params"].items():
        noise = np.zeros(a.shape, bool)
        for g in want["grads"]:
            noise |= np.abs(g[leaf]) <= HYB_GRAD_TOL * np.abs(g[leaf]).max()
        tol = np.where(noise, 2 * lr * steps,
                       TOL_EF_PARAMS if ef else TOL_F32)
        d = np.abs(got["params"][leaf] - a)
        assert np.all(d <= tol), (leaf, float(d.max()),
                                  int((d > tol).sum()))


def test_hybrid_heads_split_over_model_equal_jax_prefill(runs):
    """reduced(zamba2-7b) on (2, 4): each rank holds 74 of in_w's 296
    packed columns (and 32 of its 64 rows, ZeRO-3), runs two of the 8
    Mamba2 heads and one of the shared block's 4, and the prefill's logits
    equal the JAX package's GSPMD run on the same weights."""
    jx = runs["jax"]
    for r in runs["ranks"]:
        assert r["hybrid"]["mamba_in_w"] == (32, 74)
        np.testing.assert_allclose(r["hyb_prefill"], jx["hyb_prefill"],
                                   atol=2e-3)


def test_hybrid_full_width_builds_on_model_axis(runs):
    """zamba2-7b at full width on (2, 4), on the meta device: a rank holds
    28 of the 112 Mamba2 heads' a_log and d_skip, their 1,792 conv
    columns and out_w rows, 3,644 of in_w's 14,576 packed columns (its
    3,584 rows over the data axis), gn and dt_bias whole, and 8 of the
    shared block's 32 query heads of 112."""
    for r in runs["ranks"]:
        assert r["hybrid"]["full_width"] == {
            "norm1": (3584,), "in_w": (1792, 3644), "conv_w": (4, 1792),
            "a_log": (28,), "dt_bias": (112,), "d_skip": (28,),
            "gn": (7168,), "out_w": (1792, 1792), "shared.wq": (1792, 896)}


@pytest.mark.parametrize("mode", ["tp", "cp"])
def test_hybrid_decode_logits_and_caches_equal_jax(runs, mode):
    """"tp" and "cp" decode on (2, 4) from the JAX weights: logits, the
    Mamba2 conv and ssm states (head-split in both modes) and each shared
    application's keys and values (sequence-split in "cp") gathered whole,
    against the JAX package's."""
    jx = runs["jax"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"hyb_lg_{mode}"], jx[f"hyb_lg_{mode}"],
                                   atol=2e-3)
    caches = dict(_leaves(_nest(jx, f"hyb_cache_{mode}/")))
    got = runs["ranks"][0][f"hyb_cache_{mode}"]
    assert set(got) == set(caches)
    assert any(n.endswith("/ssm") for n in got)
    assert any(n.endswith("/k") for n in got)
    for name, want in caches.items():
        np.testing.assert_allclose(got[name], want, atol=1e-4, err_msg=name)


def test_hybrid_sharded_train_step_equals_jax(runs):
    jx = runs["jax"]
    trained = dict(_leaves(_nest(jx, "hyb_trained/")))
    for r in runs["ranks"]:
        assert abs(r["hyb_train_loss"] - float(jx["hyb_train_loss"])) < 1e-4
        assert set(r["hyb_trained"]) == set(trained)
        for name, want in trained.items():
            np.testing.assert_allclose(r["hyb_trained"][name], want,
                                       atol=2e-4, err_msg=name)


@pytest.mark.parametrize("which", ["2x4", "narrow_1x8"])
def test_hybrid_mesh_serving_equals_one_process(runs, which):
    """The prefill within 1e-5 and the engine's greedy tokens in "tp" and
    "cp" identical to one process's: on (2, 4) two Mamba2 heads a rank;
    the narrow config's H = 4 on (1, 8) every head on every rank, in_w
    gathered whole (its 292 columns are not split: 8 does not divide
    them)."""
    narrow = which.startswith("narrow")
    want = _hyb_one(narrow)
    for r in runs["ranks"]:
        got = r["hybrid"]["fwd"][which]
        assert got["layout"] == "cp"
        np.testing.assert_allclose(got["prefill"], want["prefill"],
                                   atol=TOL_F32)
        assert got["tokens"] == want["tokens"]
        if narrow:
            assert r["hybrid"]["narrow_in_w"] == (64, 292)


@pytest.mark.parametrize("case", HYB_TRAIN_CASES, ids=lambda c: c[0])
def test_hybrid_mesh_train_steps_equal_one_process(runs, case):
    want = _hyb_one_train(case)
    first = runs["ranks"][0]["hybrid"]["train"][case[0]]
    for r in runs["ranks"]:
        _assert_train_hybrid(r["hybrid"]["train"][case[0]], want, first,
                             ef=case[5])


@pytest.mark.parametrize("case", HYB_TRAIN_CASES, ids=lambda c: c[0])
def test_hybrid_replicated_leaves_bitwise_equal_over_model(runs, case):
    """After the steps, the model ranks of each data coordinate hold the
    same gn, dt_bias, norms, shared-block norms and every other leaf the
    model axis does not split, bit for bit: each rank's use of a slice of
    gn and dt_bias enters through copy_to_model."""
    name = case[0]
    _assert_replicated_equal(
        [r["hybrid"]["replicated"][name] for r in runs["ranks"]],
        [r["hybrid"]["coord"][name] for r in runs["ranks"]],
        among=(".gn", ".dt_bias", ".norm1", "shared.norm2"))


def test_hybrid_checkpoint_restores_into_one_process(runs):
    """The trained (2, 4) state saved by `CheckpointManager` (a collective
    of its mesh), restored without shardings into one process: its
    parameters are the mesh's trained ones bit for bit, and its prefill
    equals the trained mesh model's within 1e-5."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import _to_jax_layout
    from repro_torch.models import build_model
    cfg = _hyb_cfg()
    m = build_model(cfg, device="cpu")
    named = dict(m.named_parameters())
    _, back = CheckpointManager(str(runs["tmp"] / "ckpt" / "hybrid")) \
        .restore(named, device="cpu")
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(back[n])
    with _one_thread():
        want = m.prefill(_hyb_batch(cfg))[0].numpy()
    trained = runs["ranks"][0]["hybrid"]["train"]["zero3_2x4"]["params"]
    restored = dict(_leaves(_to_jax_layout(back)))
    assert set(restored) == set(trained)
    for leaf, a in trained.items():
        assert restored[leaf].tobytes() == a.tobytes(), leaf
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["hybrid"]["trained_prefill"], want,
                                   atol=TOL_F32)


def test_launchers_mesh_single_run_hybrid(runs):
    """`launch.train` and `launch.serve --decode-mode cp` `--arch zamba2-7b
    --reduced --mesh single` on (2, 4): the final loss (within 1e-5,
    relative, as `_assert_train_hybrid` holds each step's) and the tokens
    of one process's launchers."""
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    with _one_thread():
        loss = train(HYB_TRAIN_ARGV)
        tokens = sorted((r.uid, tuple(r.out)) for r in serve(HYB_SERVE_ARGV))
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["hyb_launch"]["train"], loss,
                                   rtol=TOL_F32)
        assert r["hyb_launch"]["serve"] == tokens
