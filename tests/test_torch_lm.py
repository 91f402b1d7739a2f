"""The port's language-model serving slice against the JAX package, on the
CPU.

Both packages run the same weights: the JAX model is initialised from a
key, its parameter tree goes through numpy into a port `Model`
(`convert.lm_params_from_numpy`), and the same numpy token ids go to both.
At `reduced(qwen3-4b)` (qk_norm, untied head), `reduced(granite-3-2b)`
(tied embeddings) and the two MoE configs, `reduced(olmoe-1b-7b)` and
`reduced(phi3.5-moe-42b-a6.6b)` (GQA), in f32, prefill logits and caches
agree to 1e-4 (XLA and torch sum in different orders; RoPE's f32 powers
differ by ulps, so decode is compared at every position from 0 to 40),
the greedy tokens of the serving engines are identical, and the
configurations equal the JAX package's field by field; the full MoE
configs count the JAX package's parameters on the "meta" device, with
the router f32 in a bf16 model.  The port runs on the CPU here, where its
`ops` take the plain versions of the kernels; `chip_smoke.py` drives the
same path through the CUDA kernels on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_caches_to_numpy, lm_params_from_numpy,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ATOL = 1e-4
LM_ARCHS = ["qwen3-4b", "granite-3-2b", "olmoe-1b-7b",
            "phi3.5-moe-42b-a6.6b"]


def _pair(name, seed=0, **kw):
    """(JAX model, JAX params, port model) on the same f32 weights."""
    jcfg = jreduced(JARCHS[name]).replace(dtype="float32", **kw)
    cfg = reduced(get_arch(name)).replace(dtype="float32", **kw)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_configs_equal_jax(name):
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(JARCHS[name])
    assert (dataclasses.asdict(reduced(ARCHS[name]))
            == dataclasses.asdict(jreduced(JARCHS[name])))
    assert get_arch(name) is ARCHS[name]


def test_param_count_full_qwen3_4b_on_meta():
    cfg = get_arch("qwen3-4b")
    m = Model(cfg, device="meta")
    assert m.tok_embed.device.type == "meta"
    assert m.param_count() == jbuild(JARCHS["qwen3-4b"]).param_count()
    assert 4.3e9 < m.param_count() < 4.5e9


@pytest.mark.parametrize("name,expect", [
    ("olmoe-1b-7b", 6_919_096_320), ("phi3.5-moe-42b-a6.6b", 41_872_527_360)])
def test_param_count_full_moe_on_meta(name, expect):
    m = Model(get_arch(name), device="meta")
    assert m.param_count() == jbuild(JARCHS[name]).param_count() == expect


def test_moe_router_f32_in_a_bf16_model():
    cfg = reduced(get_arch("olmoe-1b-7b"))
    assert cfg.dtype == "bfloat16"
    m = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert m.dtype == torch.bfloat16
    for layer in m.segments["seg_00"]:
        assert layer["router"].dtype == torch.float32
        assert all(t.dtype == torch.bfloat16 for n, t in layer.items()
                   if n != "router")
    assert layer["we_g"].shape == (cfg.moe.n_experts, cfg.d_model, cfg.d_ff)
    assert layer["we_d"].shape == (cfg.moe.n_experts, cfg.d_ff, cfg.d_model)
    # the JAX package's tree fills it the same way
    jm = jbuild(jreduced(JARCHS["olmoe-1b-7b"]))
    tm = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32),
                     jm.init(jax.random.key(0))), cfg, device="cpu")
    assert tm.segments["seg_00"][1]["router"].dtype == torch.float32
    assert tm.segments["seg_00"][1]["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    logits, _ = tm.prefill({"tokens": toks})
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("impl", ["chunked", "flash"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_matches_jax(name, impl):
    jm, params, tm = _pair(name, attn_impl=impl)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 64))
    lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, ct = tm.prefill({"tokens": toks})
    assert lt.dtype == torch.float32 and lt.shape == (2, tm.cfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    cj, ct = jax.tree.map(np.asarray, cj), lm_caches_to_numpy(ct)
    assert sorted(cj) == sorted(ct) == ["seg_00"]
    for key in ("k", "v"):
        assert ct["seg_00"][key].shape == cj["seg_00"][key].shape
        np.testing.assert_allclose(ct["seg_00"][key], cj["seg_00"][key],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_step_matches_jax_at_positions_0_to_40(name):
    jm, params, tm = _pair(name, seed=2)
    b, cache_len = 2, 64
    jc = jm.init_cache(b, cache_len)
    tc = tm.init_cache(b, cache_len)
    jstep = jax.jit(jm.decode_step)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (41, b, 1))
    for t in range(41):
        pos = np.full((b,), t, np.int32)
        lj, jc = jstep(params, jc, jnp.asarray(toks[t], jnp.int32),
                       jnp.asarray(pos))
        lt, tc = tm.decode_step(tc, toks[t], pos)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   rtol=0, err_msg=f"position {t}")
    jc, tcn = jax.tree.map(np.asarray, jc), lm_caches_to_numpy(tc)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcn["seg_00"][key], jc["seg_00"][key],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_matches_forward(name):
    """Prefill(S) + decode(token S) == prefill(S+1), the JAX package's own
    check (`tests/test_models_smoke.py`), at its 2e-3 bar."""
    _, _, tm = _pair(name, seed=1)
    b, s = 2, 16
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (b, s + 1))
    lg1, caches = tm.prefill({"tokens": toks[:, :s]})
    lg2, _ = tm.prefill({"tokens": toks[:, :s + 1]})
    padded = {seg: [{k: torch.cat([c[k], torch.zeros_like(c[k][:, :4])], 1)
                     for k in c} for c in layers]
              for seg, layers in caches.items()}
    lg_dec, _ = tm.decode_step(padded, toks[:, s:s + 1],
                               np.full((b,), s, np.int64))
    np.testing.assert_allclose(lg_dec.numpy(), lg2.numpy(), atol=2e-3)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_serve_engine_tokens_identical_to_jax(name):
    """5 requests on 2 slots with recycling (by max_new, and one at
    cache_len - 1), token for token as the JAX engine serves them."""
    jm, params, tm = _pair(name, seed=4)
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, tm.cfg.vocab, n), m)
             for n, m in ((4, 4), (6, 3), (3, 5), (10, 40), (5, 4))]
    jeng = JServeEngine(jm, params, n_slots=2, cache_len=24)
    teng = ServeEngine(tm, n_slots=2, cache_len=24)
    jdone = jeng.run([JRequest(uid=i, prompt=p.astype(np.int32), max_new=m)
                      for i, (p, m) in enumerate(specs)])
    tdone = teng.run([Request(uid=i, prompt=p, max_new=m)
                      for i, (p, m) in enumerate(specs)])
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert [r.slot for r in tdone] == [r.slot for r in jdone]
    # uid 3 ran out of cache (10 prompt tokens, cache_len 24), not max_new
    assert len(tdone[[r.uid for r in tdone].index(3)].out) == 24 - 1 - 10
    assert teng.n_decode_calls == sum(len(p) for p, _ in specs) + len(
        teng.step_seconds)


def test_flash_route_plain_equals_chunked():
    cfg = reduced(get_arch("qwen3-4b")).replace(dtype="float32")
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 64, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 64, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 64, 2, 16)).astype(np.float32))
    chunked = attn._chunked_causal_attention(q, k, v, cfg)
    flash = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), atol=2e-5,
                               rtol=0)


def test_init_from_generator_is_deterministic():
    cfg = reduced(get_arch("qwen3-4b")).replace(dtype="float32")

    def make(seed):
        return build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(seed))
    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["tok_embed"], sc["tok_embed"])
    layer = a.segments["seg_00"][0]
    assert torch.equal(layer["norm1"], torch.ones(cfg.d_model))
    assert torch.equal(layer["qn"], torch.ones(cfg.hd))
    assert a.lm_head.shape == (cfg.d_model, cfg.vocab)
    # the parameters are trainable (Model.loss); init records no graph
    assert all(p.requires_grad and p.grad_fn is None for p in a.parameters())


def test_launch_serve_runs_on_cpu():
    from repro_torch.launch.serve import main
    done = main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--prompt-len", "4",
                 "--max-new", "3", "--cache-len", "16"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)


def test_unported_parts_raise(monkeypatch):
    import socket
    import torch.distributed as dist
    from repro_torch.distributed.shardings import ModelMesh
    from repro_torch.launch.serve import main
    # `--mesh single` joins the torchrun ranks (here one) and builds the
    # production mesh, which one rank is too few for: torch's own error
    # (`test_torch_lm_mesh.py` serves on a small mesh)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        with pytest.raises(RuntimeError, match="256"):
            main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                  "--mesh", "single"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # the frontend families build and run (`test_torch_frontend.py` and
    # `test_torch_encdec.py` hold them to the JAX package)
    for name in ("seamless-m4t-medium", "internvl2-2b"):
        cfg = reduced(get_arch(name)).replace(dtype="float32")
        m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        fe = np.zeros((1, cfg.frontend_len, cfg.frontend_dim), np.float32)
        logits, _ = m.prefill({"tokens": np.zeros((1, 3), np.int64),
                               "frontend": fe})
        assert logits.shape == (1, cfg.vocab)
        assert bool(torch.isfinite(logits).all())
    cfg = reduced(get_arch("qwen3-4b")).replace(dtype="float32")
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    x = torch.zeros((1, 1, cfg.d_model))
    cache = attn.init_kv_cache(cfg, 1, 8, torch.float32, "cpu")
    p = tm.segments["seg_00"][0]
    # "cp" without a mesh runs as "tp", and so it does on a mesh without a
    # model axis (`test_torch_lm_mesh.py` runs it on model axes)
    out_cp, _ = attn.attention_decode(p, x, cfg, dict(cache),
                                      torch.zeros(1, dtype=torch.long), "cp")
    assert out_cp.shape == (1, 1, cfg.d_model)

    class DataOnly:
        shape = {"data": 1}
    out_mesh, _ = attn.attention_decode(
        p, x, cfg, dict(cache), torch.zeros(1, dtype=torch.long), mode="cp",
        mp=ModelMesh(DataOnly()))
    assert torch.equal(out_mesh, out_cp)
    # a cache write past the end raises (the JAX package would clamp it)
    with pytest.raises(IndexError):
        attn._update_cache(cache["k"], torch.zeros((1, 1, 2, 16)),
                           torch.full((1,), 8, dtype=torch.long))
    eng = ServeEngine(tm, n_slots=1, cache_len=4)
    with pytest.raises(RuntimeError, match="cache_len"):
        eng._decode(np.zeros((1, 1), np.int64), np.full((1,), 4, np.int64))
