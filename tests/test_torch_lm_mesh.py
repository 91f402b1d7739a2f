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

Bars.  Against the JAX package, its tests' own: CP and TP decode logits
2e-3 and caches 1e-4 (also CP against TP), the sharded step's loss 1e-4
and parameters 2e-4.  Against the port's one-process runs, in f32: greedy
tokens identical, decode and prefill logits 1e-5, per-step loss and grad
norm 1e-5 (relative), parameters after the steps 1e-5 (2e-4 with error
feedback, where a code one step off in the int8 quantization moves a
parameter by up to two learning rates of AdamW's first steps), a resumed
mesh run bit for bit the uninterrupted one, and every rank's results the
same.
"""
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
OTHER_KINDS = ["olmoe-1b-7b", "zamba2-7b", "xlstm-1.3b", "internvl2-2b",
               "seamless-m4t-medium"]


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
q_cfg = reduced(ARCHS["qwen3-4b"]).replace(dtype="float32")
q_m = build_model(q_cfg)
tcfg = TrainConfig()
batch = {k: jnp.asarray(v) for k, v in TokenPipeline(q_cfg.vocab, 8, 16,
                                                    seed=0).batch_at(0).items()}
state0 = train_state_init(q_m.init(jax.random.key(0)), tcfg)
put("granite/", params)
put("qwen/", state0.params)
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
# test_sharded_train_step_matches_single_device
mesh = compat_mesh((2, 2, 2), ("pod", "data", "model"))
with shard_ctx(mesh), mesh:
    state1 = train_state_init(q_m.init(jax.random.key(0)), tcfg)
    s_sh, met = jax.jit(make_train_step(q_m, tcfg))(state1, batch)
out["train_loss"] = np.asarray(met["loss"])
put("trained/", s_sh.params)
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
    out = {}
    for seg, layers in caches.items():
        whole = {}
        for name in layers[0]:
            ts = []
            for c in layers:
                t = c[name]
                if mode == "cp" and mp.size > 1:
                    t = mp.gather(t.contiguous(), 1)
                elif mp.splits(cfg.n_kv_heads):
                    t = mp.gather(t.contiguous(), 2)
                ts.append(mp.gather_rows(t, b).numpy())
            whole[name] = np.stack(ts)
        out[seg] = whole
    return out


def _serve(model, mode: str, cache_len: int = 16):
    """Five requests on three slots (recycling), prompt 5, 4 new tokens."""
    from repro_torch.serving.engine import Request, ServeEngine
    rng = np.random.default_rng(1)
    eng = ServeEngine(model, n_slots=3, cache_len=cache_len, decode_mode=mode)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab, 5),
                    max_new=4) for i in range(5)]
    return sorted((r.uid, tuple(r.out)) for r in eng.run(reqs))


def _train(model, tcfg, steps: int = STEPS):
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.training.step import make_train_step, train_state_init
    pipe = TokenPipeline(model.cfg.vocab, 8, 16, seed=0)
    st = train_state_init({n: p.detach() for n, p in
                           model.named_parameters()}, tcfg)
    step = make_train_step(model, tcfg)
    mets = []
    for i in range(steps):
        st, met = step(st, pipe.batch_at(i))
        mets.append([float(met[k]) for k in ("loss", "grad_norm", "lr")])
    return {"metrics": mets,
            "params": dict(_leaves(train_state_to_numpy(st).params))}


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
