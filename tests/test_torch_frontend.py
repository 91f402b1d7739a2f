"""The port's vision-language family (internvl2-2b: a projected patch
prefix before the tokens) against the JAX package, on the CPU.

The same numpy inputs and weights go through the JAX function and the
port's, in f32 at `reduced(internvl2-2b)` (8 patches of 32, d 64), the
JAX model's weights carried by `convert.lm_params_from_numpy`.  The
helpers here take any frontend family; `test_torch_encdec.py` runs them on
seamless-m4t-medium.  Bars, each stated where it is used:

  * `frontend_project` within 1e-6 of max(1, max |want|) (its GELU is the
    tanh form, `jax.nn.gelu`'s default; torch's default erf form is
    further off than that);
  * prefill logits and caches (`lm_caches_to_numpy`) within 1e-4 of
    max(1, the largest magnitude); decode_step after a prefill, at
    position F + S for the prefix, within 1e-4 of the JAX package's and
    within the reference's 2e-3 of the longer prefill;
  * the loss within 1e-5 relative and every gradient within 1e-4 of its
    leaf's largest magnitude (the frontend's included);
  * one `adamw_update` within one f32 ulp of the JAX package's, leaf by
    leaf, and the decay rule of the JAX layout (fe_norm and final_norm,
    rank 1 there, not decayed);
  * three train steps with `test_torch_train.py`'s bars, batches carrying
    "frontend"; `train_state_to_numpy` round trips exactly;
  * the serving engines' greedy tokens identical (the engine prefills
    token by token through decode_step: no prefix, as in the reference);
  * the full config's `param_count` on the "meta" device equal to the JAX
    package's; `launch.serve` and `launch.train` on the CPU, the
    launcher's frontend batches drawn as the JAX launcher draws them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import frontend as jfrontend  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.training.step import make_train_step as jmake_step  # noqa: E402
from repro.training.step import train_state_init as jstate_init  # noqa: E402
from repro_torch.configs import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _from_jax_layout, _to_jax_layout, lm_caches_to_numpy,
    lm_params_from_numpy, train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import frontend  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from test_torch_train import (  # noqa: E402
    _assert_metrics, _assert_states, _leaves, _printed_losses,
)

ARCH = "internvl2-2b"
ATOL = 1e-4
GRAD_TOL = 1e-4


def _cfgs(name, **kw):
    return (jreduced(JARCHS[name]).replace(dtype="float32", **kw),
            reduced(get_arch(name)).replace(dtype="float32", **kw))


def _pair(name, seed=0, **kw):
    """(JAX model, JAX params, port model) on the same f32 weights."""
    jcfg, cfg = _cfgs(name, **kw)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jm, params, tm


def _close(got, want, atol, what=""):
    want = np.asarray(want)
    tol = atol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert got.shape == want.shape and err <= tol, f"{what}: {err} > {tol}"


def _batch(cfg, b, s, seed):
    """Tokens, next-token labels and frontend embeddings (B, F, dim)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frontend": rng.normal(size=(b, cfg.frontend_len,
                                         cfg.frontend_dim)
                                   ).astype(np.float32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _with_frontend(cfg, batch, step, seed):
    """A token batch with the launchers' frontend draw for `step`."""
    rng = np.random.default_rng([seed, step])
    return dict(batch, frontend=rng.normal(
        size=(len(batch["tokens"]), cfg.frontend_len, cfg.frontend_dim)
    ).astype(np.float32))


def _pad(caches, n):
    """Room for n more self-attention positions (the cross keys and values
    and recurrent state as they are)."""
    return {seg: [{k: torch.cat([t, torch.zeros_like(t[:, :n])], 1)
                   if k in ("k", "v") else t for k, t in c.items()}
                  for c in layers] for seg, layers in caches.items()}


def _jpad(caches, n):
    return {seg: {k: jnp.concatenate(
        [t, jnp.zeros_like(t[:, :, :n])], 2) if k in ("k", "v") else t
        for k, t in c.items()} for seg, c in caches.items()}


# ------------------------------------------------------------- the helpers

def check_prefill(name):
    jm, params, tm = _pair(name, seed=1)
    for s in (16, 21):
        batch = _batch(tm.cfg, 2, s, seed=s)
        lj, cj = jm.prefill(params, _jbatch(batch))
        lt, ct = tm.prefill(batch)
        assert lt.dtype == torch.float32
        _close(lt.numpy(), lj, ATOL, f"logits S={s}")
        cj, ct = jax.tree.map(np.asarray, cj), lm_caches_to_numpy(ct)
        assert sorted(cj) == sorted(ct)
        for seg in cj:
            assert sorted(cj[seg]) == sorted(ct[seg]), seg
            for k in cj[seg]:
                _close(ct[seg][k], cj[seg][k], ATOL, f"{seg}/{k} S={s}")
    return ct


def check_decode_after_prefill(name):
    """Two decode steps after a prefill of S tokens (positions S + n_prefix
    and one more) against the JAX package's on the same caches; the first
    also against the prefill of S + 1 tokens at the reference's 2e-3."""
    jm, params, tm = _pair(name, seed=2)
    b, s = 2, 12
    batch = _batch(tm.cfg, b, s + 2, seed=5)
    short = dict(batch, tokens=batch["tokens"][:, :s])
    _, jc = jm.prefill(params, _jbatch(short))
    _, tc = tm.prefill(short)
    n_prefix = 0 if tm.cfg.is_encdec else tm.cfg.frontend_len
    jc, tc = _jpad(jc, 2), _pad(tc, 2)
    jstep = jax.jit(jm.decode_step)
    for i in range(2):
        pos = np.full((b,), n_prefix + s + i, np.int32)
        tok = batch["tokens"][:, s + i:s + i + 1]
        lj, jc = jstep(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        lt, tc = tm.decode_step(tc, tok, pos)
        _close(lt.numpy(), lj, ATOL, f"decode at {int(pos[0])}")
        if i == 0:
            longer, _ = tm.prefill(dict(batch,
                                        tokens=batch["tokens"][:, :s + 1]))
            np.testing.assert_allclose(lt.numpy(), longer.numpy(),
                                       atol=2e-3)
    jc, tcn = jax.tree.map(np.asarray, jc), lm_caches_to_numpy(tc)
    for seg in jc:
        for k in jc[seg]:
            _close(tcn[seg][k], jc[seg][k], ATOL, f"{seg}/{k}")


def check_loss_and_gradients(name):
    jm, params, tm = _pair(name)
    batch = _batch(tm.cfg, 4, 32, seed=3)
    jl, jg = jax.value_and_grad(jm.loss)(params, _jbatch(batch))
    loss = tm.loss(batch)
    loss.backward()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    got = _leaves(_to_jax_layout({n: p.grad for n, p in
                                  tm.named_parameters()}))
    want = _leaves(jax.tree.map(np.asarray, jg))
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert np.isfinite(got[k]).all() and err <= GRAD_TOL * scale, \
            f"{k}: {err} > {GRAD_TOL} * {scale}"
    return sorted(want)


def check_adamw_update(name, not_decayed: set):
    """One update at lr 1e-2 from random moments and gradients, every leaf
    within one f32 ulp of the JAX package's; then the decay rule: weight
    decay (lr * wd * p, 1e-3 of a leaf) moves every leaf of the JAX layout
    but `not_decayed` (its 1-d leaves)."""
    jcfg, cfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(7)

    def like(scale, positive=False):
        def f(a):
            r = scale * rng.normal(size=a.shape)
            return (np.abs(r) if positive else r).astype(np.float32)
        return jax.tree.map(f, params)
    grads, mu, nu = like(1e-3), like(1e-3), like(1e-6, positive=True)
    step = np.int32(3)

    def jax_update(wd):
        return jadamw.adamw_update(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, grads),
            jadamw.AdamWState(jnp.asarray(step),
                              jax.tree.map(jnp.asarray, mu),
                              jax.tree.map(jnp.asarray, nu)), 1e-2,
            weight_decay=wd)
    jp, jst = jax_update(0.1)
    tm = lm_params_from_numpy(params, cfg, device="cpu")
    tp = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tst = adamw.adamw_update(
        tp, _from_jax_layout(grads, tp, "cpu"),
        adamw.AdamWState(torch.tensor(step), _from_jax_layout(mu, tp, "cpu"),
                         _from_jax_layout(nu, tp, "cpu")), 1e-2)
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        got, want = _leaves(_to_jax_layout(got)), _leaves(
            jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for k in want:
            ulp = np.spacing(np.abs(want[k]).astype(np.float32))
            assert (np.abs(got[k] - want[k]) <= ulp).all(), k
    with_wd = _leaves(jax.tree.map(np.asarray, jp))
    no_wd = _leaves(jax.tree.map(np.asarray, jax_update(0.0)[0]))
    before = _leaves(params)
    moved = {k for k, a in with_wd.items()
             if float(np.abs(a - no_wd[k]).max())
             > 5e-4 * float(np.abs(before[k]).max())}
    assert moved == set(with_wd) - not_decayed, sorted(
        moved ^ (set(with_wd) - not_decayed))


def check_train_steps(name, compress: bool):
    """Three steps of batches with "frontend" in both packages, the state
    after them, and `train_state_to_numpy` / `train_state_from_numpy`
    round trips (exact in f32)."""
    jcfg, cfg = _cfgs(name)
    jm = jbuild(jcfg)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              compress_cross_pod=compress)
    jt, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jstate_init(jm.init(jax.random.key(0)), jt)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=2)
    jstep = jax.jit(jmake_step(jm, jt))
    step = make_train_step(Model(cfg, device="meta"), tc)
    jmets, mets = [], []
    for i in range(3):
        batch = _with_frontend(cfg, pipe.batch_at(i), i, seed=2)
        jstate, m = jstep(jstate, _jbatch(batch))
        jmets.append(jax.tree.map(np.asarray, m))
        state, m = step(state, batch)
        mets.append({k: v.numpy().copy() for k, v in m.items()})
    _assert_metrics(mets, jmets)
    _assert_states(state, jstate, compress)
    tree = train_state_to_numpy(state)
    back = train_state_to_numpy(train_state_from_numpy(tree, cfg,
                                                       device="cpu"))
    for part in ("params", "opt", "ef"):
        a, b = getattr(tree, part), getattr(back, part)
        if part == "opt":
            assert int(a.step) == int(b.step) == 3
            a, b = {"mu": a.mu, "nu": a.nu}, {"mu": b.mu, "nu": b.nu}
        elif part == "ef":
            if not compress:
                assert a == b == ()
                continue
            a, b = a.residual, b.residual
        la, lb = _leaves(a), _leaves(b)
        assert sorted(la) == sorted(lb)
        assert all(np.array_equal(la[k], lb[k]) for k in la), part
    return tree


def check_engine_tokens(name):
    """5 requests on 2 slots, staggered and recycled (by max_new, and one at
    cache_len - 1): identical greedy tokens and caches."""
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
    assert [r.slot for r in tdone] == [r.slot for r in jdone]
    assert [r.out for r in tdone] == [r.out for r in jdone]
    jc, tc = jax.tree.map(np.asarray, jeng.caches), lm_caches_to_numpy(
        teng.caches)
    for seg in jc:
        for k in jc[seg]:
            _close(tc[seg][k], jc[seg][k], ATOL, f"{seg}/{k}")
    return tc


def check_param_count_full(name, want):
    m = Model(get_arch(name), device="meta")
    assert m.param_count() == jbuild(JARCHS[name]).param_count() == want
    return m


def check_launchers(capsys, monkeypatch, name):
    """`launch.serve` and `launch.train` on the CPU: every train step's
    batch carries the JAX launcher's frontend draw for (seed, step)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import main as serve
    done = serve(["--arch", name, "--reduced", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--prompt-len", "4",
                  "--max-new", "3", "--cache-len", "16"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    seen = []

    def recording(model, tcfg):
        step = make_train_step(model, tcfg)

        def run(state, batch):
            seen.append(batch)
            return step(state, batch)
        return run
    monkeypatch.setattr(launch_train, "make_train_step", recording)
    final = launch_train.main(["--arch", name, "--reduced", "--steps", "12",
                               "--batch", "4", "--seq", "32", "--lr", "3e-3",
                               "--log-every", "1", "--seed", "3",
                               "--device", "cpu"])
    cfg = reduced(get_arch(name))
    assert len(seen) == 12
    for i, batch in enumerate(seen):
        want = np.random.default_rng([3, i]).normal(
            size=(4, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
        assert batch["frontend"].dtype == np.float32
        assert np.array_equal(batch["frontend"], want)
    losses = _printed_losses(capsys.readouterr().out)
    assert len(losses) == 12 and np.isfinite(final)
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


# ------------------------------------------------------------- internvl2-2b

def test_frontend_project_matches_jax():
    jcfg, cfg = _cfgs(ARCH)
    p = jax.tree.map(np.asarray, jfrontend.init_frontend(jax.random.key(3),
                                                         jcfg))
    emb = (3.0 * np.random.default_rng(3).normal(
        size=(2, cfg.frontend_len, cfg.frontend_dim))).astype(np.float32)
    want = np.asarray(jfrontend.frontend_project(p, jnp.asarray(emb), jcfg))
    got = frontend.frontend_project({k: torch.from_numpy(np.array(v))
                                     for k, v in p.items()},
                                    torch.from_numpy(emb), cfg)
    _close(got.numpy(), want, 1e-6, "frontend_project")
    assert sorted(frontend.frontend_shapes(cfg)) == sorted(p)
    assert all(frontend.frontend_shapes(cfg)[k] == v.shape
               for k, v in p.items())


def test_internvl2_prefill_and_caches_match_jax():
    ct = check_prefill(ARCH)
    # the cache covers the prefix and the tokens
    cfg = reduced(get_arch(ARCH))
    assert ct["seg_00"]["k"].shape[2] == cfg.frontend_len + 21


def test_internvl2_embed_puts_the_prefix_first():
    jm, params, tm = _pair(ARCH)
    batch = _batch(tm.cfg, 2, 5, seed=9)
    x, n_prefix = tm._embed(batch)
    jx, jn = jm._embed(params, _jbatch(batch))
    assert n_prefix == jn == tm.cfg.frontend_len
    assert x.shape == (2, tm.cfg.frontend_len + 5, tm.cfg.d_model)
    _close(x.detach().numpy(), jx, 1e-6, "embed")
    assert torch.equal(x[:, n_prefix:],
                       tm.tok_embed[torch.from_numpy(batch["tokens"]).long()])


def test_internvl2_decode_after_prefill_matches_jax():
    check_decode_after_prefill(ARCH)


def test_internvl2_loss_and_gradients_match_jax():
    names = check_loss_and_gradients(ARCH)
    assert {"frontend/fe_w1", "frontend/fe_w2", "frontend/fe_norm"} <= \
        set(names)


def test_internvl2_adamw_update_matches_jax_leaf_by_leaf():
    # seg_00 (2 layers) is stacked: its norms decay; fe_norm is 1-d
    check_adamw_update(ARCH, {"final_norm", "frontend/fe_norm"})


@pytest.mark.parametrize("compress", [False, True])
def test_internvl2_train_steps_match_jax(compress):
    check_train_steps(ARCH, compress)


def test_internvl2_serve_engine_tokens_identical_to_jax():
    check_engine_tokens(ARCH)


def test_internvl2_param_count_full_on_meta():
    m = check_param_count_full(ARCH, 1_895_440_384)
    assert sum(p.numel() for p in m.frontend.values()) == 6_293_504
    assert sum(p.numel() for layers in m.segments.values()
               for layer in layers for p in layer.values()) == 1_510_047_744
    assert m.encoder is None


def test_internvl2_launchers_run_on_cpu(capsys, monkeypatch):
    check_launchers(capsys, monkeypatch, ARCH)
