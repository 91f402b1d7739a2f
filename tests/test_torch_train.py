"""The port's training path against the JAX package, on the CPU.

Both packages run the same weights: the JAX model is initialised from a
key and its parameter tree goes through numpy into the port
(`convert.lm_params_from_numpy`, `train_state_from_numpy`); batches come
from `TokenPipeline`, numpy-identical in both.  In f32 at reduced sizes:

  * `cross_entropy_chunked` (one chunk, several, S not a multiple of the
    chunk) and its gradients within 1e-6 of the JAX function's;
  * `Model.loss` and every gradient against `jax.value_and_grad` of the
    JAX model's loss (reduced granite-3-2b, tied embeddings; reduced
    qwen3-4b, qk_norm; the two reduced MoE configs): loss relative 1e-5,
    each gradient leaf within 1e-4 of its largest magnitude;
  * one `adamw_update` on the same numpy state and gradients (reduced
    qwen3-4b, 2 layers and 1): every leaf within one f32 ulp of the JAX
    package's, the per-layer norms included, which the JAX package decays
    as rows of a stacked (L, D) leaf (and, at 1 layer, does not);
  * remat none / full / dots give the same bits inside the port;
  * five train steps from one `TrainState` (microbatches 1 and 4,
    error feedback on and off): `step` equal and `lr` within one f32 ulp
    at every step; the first step's loss and grad_norm within 1e-6
    relative; over the five, loss relative 1e-4 and grad_norm 1e-3.  The
    states then differ where AdamW amplifies f32 noise: an element whose
    gradient is near zero (|g| ~ eps) takes an update of either sign, up to
    about lr a step, so parameters are held to 2e-3 (the five learning
    rates sum to 3.9e-3) and at most 5 % of elements off by more than
    1e-5; the moments to 2e-3 (mu) and 3e-3 (nu) of their largest
    magnitude, plus, with error feedback, one int8 quantum (1/127 of
    mu's scale; 2/127 of nu's), which a gradient moves when its quotient
    lies at a rounding boundary in one package and not the other;
  * `compress_int8` bitwise (half-way quotients round to even in both);
  * checkpoint resume bitwise in the port, and across the packages: a
    state saved by either package's `CheckpointManager` restores in the
    other and the next step agrees within the bars above;
  * `launch.train.main` and `examples.train_lm.main` on the CPU: the loss
    falls.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.layers import cross_entropy_chunked as jce  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.training.step import make_train_step as jmake_step  # noqa: E402
from repro.training.step import train_state_init as jstate_init  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _from_jax_layout, _to_jax_layout, lm_params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import cross_entropy_chunked  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402
from repro_torch.training import (  # noqa: E402
    make_train_step, param_groups, train_state_init,
)

LM_ARCHS = ["granite-3-2b", "qwen3-4b", "olmoe-1b-7b",
            "phi3.5-moe-42b-a6.6b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs(name, **kw):
    return (jreduced(JARCHS[name]).replace(dtype="float32", **kw),
            reduced(get_arch(name)).replace(dtype="float32", **kw))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _leaves(tree, prefix=""):
    """{path: numpy} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach().numpy()
                                         if isinstance(v, torch.Tensor) else v)
    return out


def _assert_leaves(got: dict, want: dict, rel: float):
    """Each leaf within rel of the want leaf's largest magnitude."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= rel * scale, f"{k}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("s,chunk", [(64, 64), (64, 16), (48, 32)])
def test_cross_entropy_chunked_matches_jax(s, chunk):
    rng = np.random.default_rng(s + chunk)
    h = rng.normal(size=(2, s, 24)).astype(np.float32)
    w = (0.3 * rng.normal(size=(24, 40))).astype(np.float32)
    lab = rng.integers(0, 40, (2, s)).astype(np.int32)
    jl, (jdh, jdw) = jax.value_and_grad(
        lambda h, w: jce(h, w, jnp.asarray(lab), None, seq_chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = cross_entropy_chunked(th, tw, torch.from_numpy(lab).long(), chunk)
    tl.backward()
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=1e-6)


def _loss_and_grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss = model.loss(batch)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", LM_ARCHS)
def test_loss_and_gradients_match_jax(name):
    jcfg, cfg = _cfgs(name)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    tm = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    batch = TokenPipeline(cfg.vocab, 4, 64, seed=3).batch_at(0)
    jl, jg = jax.value_and_grad(jm.loss)(params, _jbatch(batch))
    tl, tg = _loss_and_grads(tm, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _assert_leaves(_to_jax_layout(tg), jax.tree.map(np.asarray, jg),
                   GRAD_TOL)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_remat_modes_bitwise(name):
    _, cfg = _cfgs(name)
    batch = TokenPipeline(cfg.vocab, 2, 64, seed=4).batch_at(0)
    outs = []
    for remat in ("none", "full", "dots"):
        m = Model(cfg.replace(remat=remat), device="cpu").init(
            torch.Generator().manual_seed(1))
        outs.append(_loss_and_grads(m, batch))
    (l0, g0), rest = outs[0], outs[1:]
    for l1, g1 in rest:
        assert torch.equal(l0, l1)
        assert all(torch.equal(g0[n], g1[n]) for n in g0)


def _launch_counts(monkeypatch):
    calls = dict.fromkeys(("rms_fwd", "rms_bwd", "swi_fwd", "swi_bwd"), 0)

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(ops, "_rmsnorm_fwd", counted("rms_fwd",
                                                     ops._rmsnorm_fwd))
    monkeypatch.setattr(ops, "_swiglu_fwd", counted("swi_fwd",
                                                    ops._swiglu_fwd))
    monkeypatch.setattr(ops._ref, "rmsnorm_bwd_ref",
                        counted("rms_bwd", ops._ref.rmsnorm_bwd_ref))
    monkeypatch.setattr(ops._ref, "swiglu_bwd_ref",
                        counted("swi_bwd", ops._ref.swiglu_bwd_ref))
    return calls


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_kernel_calls_per_step(monkeypatch, remat):
    """Per train step of L blocks: rmsnorm forward 2L + 1, again 2L where
    the blocks are rematerialized; swiglu forward L (2L); one backward each
    (rmsnorm 2L + 1, swiglu L).  `chip_smoke.py` asserts these counts for
    the kernels' launches on the card."""
    _, cfg = _cfgs("granite-3-2b", remat=remat)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    state = train_state_init({n: p.detach() for n, p in
                              m.named_parameters()}, tc)
    calls = _launch_counts(monkeypatch)
    make_train_step(m, tc)(state, TokenPipeline(cfg.vocab, 2, 64)
                           .batch_at(0))
    n = cfg.n_layers
    again = 0 if remat == "none" else 1
    assert calls == {"rms_fwd": 2 * n + 1 + again * 2 * n,
                     "swi_fwd": n + again * n,
                     "rms_bwd": 2 * n + 1, "swi_bwd": n}


def _jax_run(jm, jcfg_t, jstate, pipe, steps, start=0):
    step = jax.jit(jmake_step(jm, jcfg_t))
    mets = []
    for s in range(start, start + steps):
        jstate, m = step(jstate, _jbatch(pipe.batch_at(s)))
        mets.append(jax.tree.map(np.asarray, m))
    return jstate, mets


def _port_run(cfg, tcfg, state, pipe, steps, start=0):
    step = make_train_step(Model(cfg, device="meta"), tcfg)
    mets = []
    for s in range(start, start + steps):
        state, m = step(state, pipe.batch_at(s))
        mets.append({k: v.numpy().copy() for k, v in m.items()})
    return state, mets


def _assert_metrics(got, want):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert int(g["step"]) == int(w["step"])
        assert abs(float(g["lr"]) - float(w["lr"])) <= np.spacing(
            np.float32(w["lr"]))
        first = i == 0 and int(w["step"]) == 1
        for key, rel in (("loss", 1e-6 if first else 1e-4),
                         ("grad_norm", 1e-6 if first else 1e-3)):
            assert abs(float(g[key]) - float(w[key])) <= \
                rel * abs(float(w[key])), (key, i)


def _assert_states(state, jstate, compress: bool):
    got = train_state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got.opt.step) == int(want.opt.step)
    gp, wp = _leaves(got.params), _leaves(want.params)
    assert sorted(gp) == sorted(wp)
    diff = np.concatenate([np.abs(gp[k] - wp[k]).ravel() for k in wp])
    assert diff.max() <= 2e-3 and (diff > 1e-5).mean() <= 0.05
    quantum = 1 / 127 if compress else 0.0
    _assert_leaves(got.opt.mu, want.opt.mu, 2e-3 + quantum)
    _assert_leaves(got.opt.nu, want.opt.nu, 3e-3 + 2 * quantum)
    assert bool(want.ef) == bool(got.ef)
    if compress:
        assert sorted(_leaves(got.ef.residual)) == sorted(
            _leaves(want.ef.residual))


def _states(name, tc_kw, seed=0):
    jcfg, cfg = _cfgs(name)
    jm = jbuild(jcfg)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      **tc_kw)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                     **tc_kw)
    jstate = jstate_init(jm.init(jax.random.key(seed)), jt)
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                   device="cpu")
    return jm, jt, jstate, cfg, tc, state


@pytest.mark.parametrize("micro,compress", [(1, False), (4, False),
                                            (1, True), (4, True)])
def test_train_steps_match_jax(micro, compress):
    jm, jt, jstate, cfg, tc, state = _states(
        "granite-3-2b", dict(microbatches=micro, compress_cross_pod=compress))
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=2)
    jstate, jmets = _jax_run(jm, jt, jstate, pipe, 5)
    state, mets = _port_run(cfg, tc, state, pipe, 5)
    _assert_metrics(mets, jmets)
    _assert_states(state, jstate, compress)


@pytest.mark.parametrize("n_layers", [2, 1])
def test_adamw_update_matches_jax_leaf_by_leaf(n_layers):
    """One update at lr 1e-2 from random moments and gradients: a skipped
    or spurious decay moves a norm by lr * wd * 1 = 1e-3, a thousand ulps."""
    jcfg, cfg = _cfgs("qwen3-4b", n_layers=n_layers)
    assert cfg.qk_norm
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(0)))
    rng = np.random.default_rng(7)

    def like(scale, positive=False):
        def f(a):
            r = scale * rng.normal(size=a.shape)
            return (np.abs(r) if positive else r).astype(np.float32)
        return jax.tree.map(f, params)
    grads, mu, nu = like(1e-3), like(1e-3), like(1e-6, positive=True)
    step = np.int32(3)
    jp, jst = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jadamw.AdamWState(jnp.asarray(step), jax.tree.map(jnp.asarray, mu),
                          jax.tree.map(jnp.asarray, nu)), 1e-2)
    tm = lm_params_from_numpy(params, cfg, device="cpu")
    tp = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tst = adamw.adamw_update(
        tp, _from_jax_layout(grads, tp, "cpu"),
        adamw.AdamWState(torch.tensor(step),
                         _from_jax_layout(mu, tp, "cpu"),
                         _from_jax_layout(nu, tp, "cpu")), 1e-2)
    assert int(tst.step) == int(jst.step) == 4
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        got, want = _leaves(_to_jax_layout(got)), _leaves(
            jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for k in want:
            ulp = np.spacing(np.abs(want[k]).astype(np.float32))
            assert (np.abs(got[k] - want[k]) <= ulp).all(), k
    # the JAX package decays the stacked norms, by lr * wd * p ~ 1e-3
    # (a thousand ulps), and never final_norm nor a 1-layer segment's
    jp0, _ = jadamw.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jadamw.AdamWState(jnp.asarray(step), jax.tree.map(jnp.asarray, mu),
                          jax.tree.map(jnp.asarray, nu)), 1e-2,
        weight_decay=0.0)
    with_wd, no_wd = _leaves(jax.tree.map(np.asarray, jp)), _leaves(
        jax.tree.map(np.asarray, jp0))
    norms = [k for k in with_wd if k.split("/")[-1] in
             ("norm1", "norm2", "qn", "kn")]
    assert len(norms) == 4
    for k in norms + ["final_norm"]:
        decay = float(np.abs(with_wd[k] - no_wd[k]).min())
        assert (decay > 5e-4) == (n_layers > 1 and k != "final_norm"), k


def test_compress_int8_bitwise_with_jax():
    rng = np.random.default_rng(0)
    # amax 127 makes the scale exactly 1: every k + 0.5 is a half-way
    # quotient, which both round to even
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -126.5, 0.0], np.float32)
    for x in (halves, rng.normal(size=(33, 7)).astype(np.float32),
              (1e-3 * rng.normal(size=300)).astype(np.float32),
              np.zeros(5, np.float32)):
        jq, js = jcomp.compress_int8(jnp.asarray(x))
        tq, ts = compression.compress_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(),
                                                         np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
        assert np.array_equal(compression.decompress_int8(tq, ts).numpy(),
                              np.asarray(jcomp.decompress_int8(jq, js)))
    assert list(compression.compress_int8(torch.from_numpy(halves))[0]
                .numpy()) == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126, 0]


def test_error_feedback_matches_jax_on_stacked_leaves():
    """The port quantizes a segment's per-layer tensors with the one scale
    of the JAX package's stacked leaf."""
    rng = np.random.default_rng(1)
    stacked = rng.normal(size=(3, 4, 5)).astype(np.float32)
    stacked[1] *= 10.0                       # one layer sets the scale
    jg = {"segments": {"seg_00": {"wq": jnp.asarray(stacked)}},
          "tok_embed": jnp.asarray(rng.normal(size=(6, 4)), jnp.float32)}
    jout, jef = jcomp.apply_error_feedback(jg, jcomp.ef_init(jg))
    tg = {f"segments.seg_00.{i}.wq": torch.from_numpy(stacked[i])
          for i in range(3)}
    tg["tok_embed"] = torch.from_numpy(np.asarray(jg["tok_embed"]))
    tout, tef = compression.apply_error_feedback(
        tg, compression.ef_init(tg), param_groups(tg))
    for a, b in ((tout, jout), (tef.residual, jef.residual)):
        got, want = _leaves(_to_jax_layout(a)), _leaves(
            jax.tree.map(np.asarray, b))
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_cosine_lr_within_one_ulp_of_jax():
    for base, warm, total in ((3e-4, 2, 6), (1e-3, 3, 30), (3e-3, 6, 60)):
        for s in range(total + 3):
            got = adamw.cosine_lr(torch.tensor(s, dtype=torch.int32), base,
                                  warm, total)
            want = np.float32(jadamw.cosine_lr(jnp.int32(s), base, warm,
                                               total))
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= np.spacing(want)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(size=(5, 3)).astype(np.float32),
         "b": (4 * rng.normal(size=7)).astype(np.float32)}
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-6)


def test_checkpoint_resume_exact(tmp_path):
    """Kill after step 5, restore, continue: the same bits as an
    uninterrupted run (deterministic pipeline and step)."""
    _, cfg = _cfgs("granite-3-2b")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=2)

    def fresh():
        m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        return train_state_init({n: p.detach() for n, p in
                                 m.named_parameters()}, tc)
    state_a, _ = _port_run(cfg, tc, fresh(), pipe, 10)
    state_b, _ = _port_run(cfg, tc, fresh(), pipe, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, train_state_to_numpy(state_b))
    step, tree = mgr.restore(train_state_to_numpy(fresh()), device="cpu")
    assert step == 5
    state_c, _ = _port_run(cfg, tc, train_state_from_numpy(tree, cfg, "cpu"),
                           pipe, 5, start=5)
    assert all(torch.equal(state_a.params[n], state_c.params[n])
               for n in state_a.params)
    assert all(torch.equal(state_a.opt.mu[n], state_c.opt.mu[n])
               for n in state_a.opt.mu)
    assert all(torch.equal(state_a.opt.nu[n], state_c.opt.nu[n])
               for n in state_a.opt.nu)
    assert torch.equal(state_a.opt.step, state_c.opt.step)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoint_restores_across_packages(tmp_path, saver):
    jm, jt, jstate, cfg, tc, state = _states(
        "granite-3-2b", dict(compress_cross_pod=True), seed=5)
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=6)
    jstate, _ = _jax_run(jm, jt, jstate, pipe, 3)
    state, _ = _port_run(cfg, tc, state, pipe, 3)
    if saver == "jax":
        JCheckpointManager(str(tmp_path)).save(3, jstate)
        step, tree = CheckpointManager(str(tmp_path)).restore(
            train_state_to_numpy(state), device="cpu")
        state = train_state_from_numpy(tree, cfg, device="cpu")
    else:
        CheckpointManager(str(tmp_path)).save(3,
                                              train_state_to_numpy(state))
        step, jstate = JCheckpointManager(str(tmp_path)).restore(jstate)
    assert step == 3
    jstate, jmets = _jax_run(jm, jt, jstate, pipe, 1, start=3)
    state, mets = _port_run(cfg, tc, state, pipe, 1, start=3)
    _assert_metrics(mets, jmets)
    _assert_states(state, jstate, compress=True)


def _printed_losses(text: str) -> list[float]:
    return [float(v) for v in re.findall(r"^step +\d+ loss +([\d.]+)", text,
                                         re.M)]


def test_launch_train_loss_decreases(capsys):
    from repro_torch.launch.train import main
    final = main(["--arch", "granite-3-2b", "--reduced", "--steps", "30",
                  "--batch", "8", "--seq", "32", "--lr", "3e-3",
                  "--log-every", "1", "--device", "cpu"])
    losses = _printed_losses(capsys.readouterr().out)
    assert len(losses) == 30 and losses[-1] == pytest.approx(final, abs=1e-4)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


def test_example_train_lm_loss_decreases(capsys):
    from repro_torch.examples import train_lm
    final = train_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    losses = _printed_losses(out)
    assert "example finished" in out and losses[-1] == pytest.approx(
        final, abs=1e-4)
    assert final < losses[0] - 0.1
