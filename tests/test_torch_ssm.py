"""The port's Mamba2 block and the hybrid family (zamba2-7b) against the JAX
package, on the CPU.

The same numpy inputs and weights go through the JAX function and the
port's, in f32 at `reduced(zamba2-7b)` (the JAX model's weights carried by
`convert.lm_params_from_numpy`).  Bars, each stated where it is used:

  * the block (`models/ssm.py`): `_conv_causal` with and without a state
    and `_gated_norm` within 1e-6; `mamba_train` (chunk 16, and a length
    the chunk does not divide, which runs as one chunk) and its VJP
    within 1e-5 of the largest magnitude; `mamba_decode` chained token by
    token against `mamba_train` within 1e-5;
  * the reference's NaN: at chunk 256 the JAX package's gradients of
    a_log, dt_bias and in_w are not finite (its intra-chunk decay
    `where(tri, exp(mdiff), 0)` overflows above the diagonal, and 0 * inf
    is NaN in the backward); the port's are finite and equal the JAX
    package's at chunk 16 (the same function) within 1e-4;
  * the model (these helpers also serve `test_torch_xlstm.py`): prefill
    logits and caches (`lm_caches_to_numpy` against the JAX caches)
    within 1e-4 of max(1, the largest magnitude); decode_step chained
    over positions 0 to 40 within 1e-4; decode after a prefill against
    the longer prefill at the reference's 2e-3
    (`tests/test_models_smoke.py`); the loss within 1e-5 relative and
    every gradient within GRAD_TOL of its leaf's largest magnitude; one
    `adamw_update` within one f32 ulp of the JAX package's, leaf by leaf,
    with the decay rule of the JAX layout (the stacked Mamba segments'
    norm1, gn, a_log, dt_bias and d_skip decay, the shared block's norms
    and final_norm do not); five train steps with `test_torch_train.py`'s
    bars; a checkpoint across the packages; the serving engines' greedy
    tokens identical with staggered requests and recycled slots (a
    recycled slot keeps its recurrent state, as the reference's does);
  * the full config's `param_count` on the "meta" device equal to the JAX
    package's; `launch.serve` and `launch.train` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _from_jax_layout, _to_jax_layout, lm_caches_to_numpy,
    lm_params_from_numpy, train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402
from test_torch_train import (  # noqa: E402
    _assert_metrics, _assert_states, _jax_run, _leaves, _port_run,
    _printed_losses, _states,
)

ARCH = "zamba2-7b"
ATOL = 1e-4
# Each gradient leaf within this fraction of its largest magnitude.  At
# reduced zamba2-7b the port's worst leaf (the first Mamba layer's out_w)
# is 1.8e-4 off the JAX package's; the JAX package's own gradient of that
# leaf moves by 7.7e-5 between chunk 16 and chunk 64 (the same function,
# summed in another order): the Mamba scans' exp and cumsum chains and the
# gated norms amplify f32 rounding on the way back.  Called with each
# block alone, every Mamba gradient agrees within 2e-6 (below).
GRAD_TOL = {"zamba2-7b": 1e-3, "xlstm-1.3b": 1e-4}
# The first train step's grad norm, relative (`test_torch_train.py` holds
# the dense models to 1e-6).  At reduced zamba2-7b both packages' f32 norms
# lie above the exact one (the port's run in f64): the JAX package's by
# 2.7e-6, the port's by 8.7e-6, nearly all of it from the Mamba input
# projection's f32 product (run in f64, the port's comes within 1e-6).
FIRST_GNORM_RTOL = {"zamba2-7b": 1e-5, "xlstm-1.3b": 1e-6}


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


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


# ---------------------------------------------------------------- the block

def _block(seed=0, **kw):
    """The JAX package's Mamba weights (a_log and dt_bias drawn, not at
    their init of 0) and the configs."""
    jcfg, cfg = _cfgs(ARCH, **kw)
    p = jax.tree.map(np.asarray, jssm.init_mamba(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    p["a_log"] = (0.5 * rng.normal(size=p["a_log"].shape)).astype(np.float32)
    p["dt_bias"] = (0.5 * rng.normal(size=p["dt_bias"].shape)).astype(
        np.float32)
    return jcfg, cfg, p, rng


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_causal_matches_jax(with_state):
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    jo, js = jssm._conv_causal(jnp.asarray(xs), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
    to, ts = ssm._conv_causal(_t(xs), _t(w), None if st is None else _t(st))
    _close(to.numpy(), jo, 1e-6, "out")
    _close(ts.numpy(), js, 0.0, "state")


def test_gated_norm_matches_jax():
    rng = np.random.default_rng(2)
    y, z = (rng.normal(size=(2, 5, 32)).astype(np.float32) for _ in range(2))
    gn = rng.normal(size=(32,)).astype(np.float32)
    _close(ssm._gated_norm(_t(y), _t(z), _t(gn), 1e-6).numpy(),
           jssm._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(gn),
                            1e-6), 1e-6)


@pytest.mark.parametrize("s", [64, 40])     # 4 chunks of 16; one of 40
def test_mamba_train_and_vjp_match_jax(s):
    jcfg, cfg, p, rng = _block()
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def jf(p, x):
        out, cache = jssm.mamba_train(p, x, jcfg, None)
        return jnp.sum(out * dy), (out, cache)
    (_, (jo, jc)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x))
    tp = {k: _t(v, True) for k, v in p.items()}
    tx = _t(x, True)
    to, tc = ssm.mamba_train(tp, tx, cfg)
    (to * _t(dy)).sum().backward()
    _close(to.detach().numpy(), jo, 1e-5, "out")
    for k in ("conv", "ssm"):
        _close(tc[k].detach().numpy(), jc[k], 1e-5, k)
    for k in p:
        _close(tp[k].grad.numpy(), jgp[k], 1e-5, f"d{k}")
    _close(tx.grad.numpy(), jgx, 1e-5, "dx")


def test_mamba_decode_chained_matches_train():
    jcfg, cfg, p, rng = _block(seed=3)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    with torch.no_grad():
        want, cache_t = ssm.mamba_train(tp, _t(x), cfg)
        cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
        outs = [ssm.mamba_decode(tp, _t(x[:, i:i + 1]), cfg, cache)
                for i in range(20)]
    _close(torch.cat(outs, 1).numpy(), want.numpy(), 1e-5, "outputs")
    for k in ("conv", "ssm"):
        _close(cache[k].numpy(), cache_t[k].numpy(), 1e-5, k)
    # and one JAX decode step from the same state
    jo, jc = jssm.mamba_decode(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x[:, :1]), jcfg,
        jssm.init_ssm_cache(jcfg, 2), None)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    with torch.no_grad():
        _close(ssm.mamba_decode(tp, _t(x[:, :1]), cfg, cache).numpy(), jo,
               1e-6, "one decode step")
    _close(cache["ssm"].numpy(), jc["ssm"], 1e-6, "decode state")


def test_mamba_gradients_finite_at_chunk_256():
    """The port at chunk 256 against the JAX package at chunk 16 (the same
    function): finite, within 1e-4; the JAX package at chunk 256 is not
    finite (the reference behaviour ROADMAP.md records)."""
    jcfg, cfg, p, rng = _block(seed=4, ssm_chunk=256)
    x = rng.normal(size=(1, 256, cfg.d_model)).astype(np.float32)

    def jf(p, x, c):
        out, _ = jssm.mamba_train(p, x, c, None)
        return jnp.sum(out * out)
    jp = jax.tree.map(jnp.asarray, p)
    g256 = jax.grad(jf)(jp, jnp.asarray(x), jcfg)
    assert not all(bool(jnp.isfinite(g256[k]).all())
                   for k in ("a_log", "dt_bias", "in_w"))
    g16 = jax.grad(jf)(jp, jnp.asarray(x), jcfg.replace(ssm_chunk=16))
    tp = {k: _t(v, True) for k, v in p.items()}
    out, _ = ssm.mamba_train(tp, _t(x), cfg)
    (out * out).sum().backward()
    for k in p:
        g = tp[k].grad.numpy()
        assert np.isfinite(g).all(), k
        scale = float(np.abs(np.asarray(g16[k])).max())
        assert np.abs(g - np.asarray(g16[k])).max() <= 1e-4 * scale, k


# ---------------------------------------------------------------- the model

def check_prefill(name):
    jm, params, tm = _pair(name)
    for s in (64, 40):     # chunks of 16; a length the chunk does not divide
        toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, s))
        lj, cj = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)})
        lt, ct = tm.prefill({"tokens": toks})
        assert lt.dtype == torch.float32
        _close(lt.numpy(), lj, ATOL, f"logits S={s}")
        cj, ct = jax.tree.map(np.asarray, cj), lm_caches_to_numpy(ct)
        assert sorted(cj) == sorted(ct)
        for seg in cj:
            assert sorted(cj[seg]) == sorted(ct[seg]), seg
            for k in cj[seg]:
                _close(ct[seg][k], cj[seg][k], ATOL, f"{seg}/{k} S={s}")


def check_decode_chain(name):
    jm, params, tm = _pair(name, seed=2)
    b = 2
    jc, tc = jm.init_cache(b, 64), tm.init_cache(b, 64)
    jstep = jax.jit(jm.decode_step)
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab, (41, b, 1))
    for t in range(41):
        pos = np.full((b,), t, np.int32)
        lj, jc = jstep(params, jc, jnp.asarray(toks[t], jnp.int32),
                       jnp.asarray(pos))
        lt, tc = tm.decode_step(tc, toks[t], pos)
        _close(lt.numpy(), lj, ATOL, f"position {t}")
    jc, tcn = jax.tree.map(np.asarray, jc), lm_caches_to_numpy(tc)
    for seg in jc:
        for k in jc[seg]:
            _close(tcn[seg][k], jc[seg][k], ATOL, f"{seg}/{k}")


def check_decode_matches_forward(name):
    _, _, tm = _pair(name, seed=1)
    b, s = 2, 16
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (b, s + 1))
    _, caches = tm.prefill({"tokens": toks[:, :s]})
    lg2, _ = tm.prefill({"tokens": toks})
    # room for the next key and value; recurrent state is taken as it is
    padded = {seg: [{k: torch.cat([t, torch.zeros_like(t[:, :4])], 1)
                     if k in ("k", "v") else t for k, t in c.items()}
                    for c in layers] for seg, layers in caches.items()}
    lg_dec, _ = tm.decode_step(padded, toks[:, s:s + 1],
                               np.full((b,), s, np.int64))
    np.testing.assert_allclose(lg_dec.numpy(), lg2.numpy(), atol=2e-3)


def check_loss_and_gradients(name):
    jm, params, tm = _pair(name)
    batch = TokenPipeline(tm.cfg.vocab, 4, 64, seed=3).batch_at(0)
    jl, jg = jax.value_and_grad(jm.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
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
        assert np.isfinite(got[k]).all() and err <= GRAD_TOL[name] * scale, \
            f"{k}: {err} > {GRAD_TOL[name]} * {scale}"


def check_adamw_update(name, not_decayed: set, **kw):
    """One update at lr 1e-2 from random moments and gradients, every leaf
    within one f32 ulp of the JAX package's; then the decay rule: weight
    decay (lr * wd * p, 1e-3 of a leaf) moves every leaf of the JAX layout
    but `not_decayed` (its 1-d leaves).  a_log and dt_bias start from 1,
    not their init of 0, so that their decay shows."""
    jcfg, cfg = _cfgs(name, **kw)

    def shifted(tree):
        return {k: shifted(v) if isinstance(v, dict) else
                (np.asarray(v) + np.float32(1.0) if k in ("a_log", "dt_bias")
                 else np.asarray(v)) for k, v in tree.items()}
    params = shifted(jbuild(jcfg).init(jax.random.key(0)))
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


def check_train_steps(name):
    """Five steps; step 1's grad norm within FIRST_GNORM_RTOL[name], every
    other bar `test_torch_train.py`'s."""
    jm, jt, jstate, cfg, tc, state = _states(name, {})
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=2)
    jstate, jmets = _jax_run(jm, jt, jstate, pipe, 5)
    state, mets = _port_run(cfg, tc, state, pipe, 5)
    g, w = mets[0], jmets[0]
    assert int(g["step"]) == int(w["step"]) == 1
    assert abs(float(g["loss"]) - float(w["loss"])) <= \
        1e-6 * abs(float(w["loss"]))
    assert abs(float(g["grad_norm"]) - float(w["grad_norm"])) <= \
        FIRST_GNORM_RTOL[name] * float(w["grad_norm"])
    _assert_metrics(mets[1:], jmets[1:])
    _assert_states(state, jstate, compress=False)


def check_checkpoint_across_packages(tmp_path, name, saver):
    jm, jt, jstate, cfg, tc, state = _states(
        name, dict(compress_cross_pod=True))
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=6)
    jstate, _ = _jax_run(jm, jt, jstate, pipe, 2)
    state, _ = _port_run(cfg, tc, state, pipe, 2)
    if saver == "jax":
        JCheckpointManager(str(tmp_path)).save(2, jstate)
        step, tree = CheckpointManager(str(tmp_path)).restore(
            train_state_to_numpy(state), device="cpu")
        state = train_state_from_numpy(tree, cfg, device="cpu")
    else:
        CheckpointManager(str(tmp_path)).save(2, train_state_to_numpy(state))
        step, jstate = JCheckpointManager(str(tmp_path)).restore(jstate)
    assert step == 2
    jstate, jmets = _jax_run(jm, jt, jstate, pipe, 1, start=2)
    state, mets = _port_run(cfg, tc, state, pipe, 1, start=2)
    _assert_metrics(mets, jmets)
    _assert_states(state, jstate, compress=True)


def check_engine_tokens(name):
    """5 requests on 2 slots, staggered (each slot's lane runs every other
    request's prompt steps with token 0) and recycled (by max_new, and one
    at cache_len - 1)."""
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
    assert len(tdone[[r.uid for r in tdone].index(3)].out) == 24 - 1 - 10
    # a recycled slot kept its state: the caches agree after the run
    jc, tc = jax.tree.map(np.asarray, jeng.caches), lm_caches_to_numpy(
        teng.caches)
    for seg in jc:
        for k in jc[seg]:
            _close(tc[seg][k], jc[seg][k], ATOL, f"{seg}/{k}")


def check_param_count_full(name, lo, hi):
    m = Model(get_arch(name), device="meta")
    n = m.param_count()
    assert n == jbuild(JARCHS[name]).param_count() and lo <= n <= hi


def check_launchers(capsys, name):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    done = serve(["--arch", name, "--reduced", "--device", "cpu",
                  "--requests", "3", "--slots", "2", "--prompt-len", "4",
                  "--max-new", "3", "--cache-len", "16"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    final = train(["--arch", name, "--reduced", "--steps", "12", "--batch",
                   "4", "--seq", "32", "--lr", "3e-3", "--log-every", "1",
                   "--device", "cpu"])
    losses = _printed_losses(capsys.readouterr().out)
    assert len(losses) == 12 and np.isfinite(final)
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_zamba2_prefill_and_caches_match_jax():
    check_prefill(ARCH)


def test_zamba2_decode_step_matches_jax_at_positions_0_to_40():
    check_decode_chain(ARCH)


def test_zamba2_decode_matches_forward():
    check_decode_matches_forward(ARCH)


def test_zamba2_loss_and_gradients_match_jax():
    check_loss_and_gradients(ARCH)


def test_zamba2_adamw_update_matches_jax_leaf_by_leaf():
    # reduced: segments mamba x2, shared, mamba x2, shared.  The stacked
    # Mamba segments' norm1, gn, a_log, dt_bias and d_skip are (L, .)
    # leaves and decay; the shared block is not stacked.
    check_adamw_update(ARCH, {"final_norm", "shared/norm1", "shared/norm2"})


def test_zamba2_train_steps_match_jax():
    check_train_steps(ARCH)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_zamba2_checkpoint_restores_across_packages(tmp_path, saver):
    check_checkpoint_across_packages(tmp_path, ARCH, saver)


def test_zamba2_serve_engine_tokens_identical_to_jax():
    check_engine_tokens(ARCH)


def test_zamba2_param_count_full_on_meta():
    check_param_count_full(ARCH, 6e9, 9e9)
    m = Model(get_arch(ARCH), device="meta")
    assert {n for n, p in m.named_parameters()
            if p.dtype == torch.float32} == {
        f"segments.{seg}.{i}.{leaf}" for seg, count in
        ((f"seg_{2 * j:02d}", 6) for j in range(14)) for i in
        range(count if seg != "seg_26" else 3)
        for leaf in ("a_log", "dt_bias", "d_skip")}
    assert m.shared["wq"].shape == (3584, 32 * 112)


def test_zamba2_launchers_run_on_cpu(capsys):
    check_launchers(capsys, ARCH)
