"""The port's MoE language models trained, served and checkpointed against
the JAX package, on the CPU.

`reduced(olmoe-1b-7b)` and `reduced(phi3.5-moe-42b-a6.6b)` in f32 (the
`capacity` impl, as the configs set it), with the bars of
`test_torch_train.py` (whose helpers this file uses):

  * five train steps from one `TrainState` against the JAX package's
    (microbatches 1 and 4, error feedback off and on).  With error
    feedback, step 1's grad norm is held to 1e-5 (not 1e-6): the JAX
    package's f32 `global_norm` of its own compressed gradients is 1.9e-6
    off their exact (f64) norm at reduced olmoe-1b-7b, whose stacked
    expert leaves hold 65,536 elements, while the port's is 1.1e-7 off;
    every other bar is that file's;
  * checkpoint resume bitwise in the port, and across the packages both
    ways (the stacked (L, E, d, f) expert leaves and the f32 router);
  * the kernels' calls a step: the MoE block calls rmsnorm and swiglu as
    the dense block does (swiglu once, on the expert-grouped tensor);
  * `launch.train` and `launch.serve` with `--arch` of each MoE config on
    the CPU, and a bf16 train state whose router stays f32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    train_state_from_numpy, train_state_to_numpy,
)
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import make_train_step, train_state_init  # noqa: E402
from test_torch_train import (  # noqa: E402
    _assert_metrics, _assert_states, _cfgs, _jax_run, _launch_counts,
    _port_run, _printed_losses, _states,
)

MOE_ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]


EF_FIRST_GNORM_RTOL = 1e-5


@pytest.mark.parametrize("micro,compress", [(1, False), (4, False),
                                            (1, True), (4, True)])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_train_steps_match_jax(name, micro, compress):
    jm, jt, jstate, cfg, tc, state = _states(
        name, dict(microbatches=micro, compress_cross_pod=compress))
    assert state.params["segments.seg_00.0.router"].dtype == torch.float32
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=2)
    jstate, jmets = _jax_run(jm, jt, jstate, pipe, 5)
    state, mets = _port_run(cfg, tc, state, pipe, 5)
    if compress:
        g, w = mets[0], jmets[0]
        assert int(g["step"]) == int(w["step"]) == 1
        assert float(g["lr"]) == float(w["lr"])
        assert abs(float(g["loss"]) - float(w["loss"])) <= \
            1e-6 * abs(float(w["loss"]))
        assert abs(float(g["grad_norm"]) - float(w["grad_norm"])) <= \
            EF_FIRST_GNORM_RTOL * float(w["grad_norm"])
        mets, jmets = mets[1:], jmets[1:]
    _assert_metrics(mets, jmets)
    _assert_states(state, jstate, compress)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_checkpoint_resume_exact(tmp_path, name):
    _, cfg = _cfgs(name)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=2)

    def fresh():
        m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        return train_state_init({n: p.detach() for n, p in
                                 m.named_parameters()}, tc)
    state_a, _ = _port_run(cfg, tc, fresh(), pipe, 6)
    state_b, _ = _port_run(cfg, tc, fresh(), pipe, 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, train_state_to_numpy(state_b))
    step, tree = mgr.restore(train_state_to_numpy(fresh()), device="cpu")
    assert step == 3
    assert tree.params["segments"]["seg_00"]["we_g"].shape == (
        cfg.n_layers, cfg.moe.n_experts, cfg.d_model, cfg.d_ff)
    state_c, _ = _port_run(cfg, tc, train_state_from_numpy(tree, cfg, "cpu"),
                           pipe, 3, start=3)
    for a, c in ((state_a.params, state_c.params),
                 (state_a.opt.mu, state_c.opt.mu),
                 (state_a.opt.nu, state_c.opt.nu)):
        assert all(torch.equal(a[n], c[n]) for n in a)
    assert torch.equal(state_a.opt.step, state_c.opt.step)


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_checkpoint_restores_across_packages(tmp_path, name, saver):
    jm, jt, jstate, cfg, tc, state = _states(
        name, dict(compress_cross_pod=True), seed=5)
    pipe = TokenPipeline(cfg.vocab, 4, 16, seed=6)
    jstate, _ = _jax_run(jm, jt, jstate, pipe, 2)
    state, _ = _port_run(cfg, tc, state, pipe, 2)
    if saver == "jax":
        JCheckpointManager(str(tmp_path)).save(2, jstate)
        step, tree = CheckpointManager(str(tmp_path)).restore(
            train_state_to_numpy(state), device="cpu")
        state = train_state_from_numpy(tree, cfg, device="cpu")
    else:
        CheckpointManager(str(tmp_path)).save(2,
                                              train_state_to_numpy(state))
        step, jstate = JCheckpointManager(str(tmp_path)).restore(jstate)
    assert step == 2
    jstate, jmets = _jax_run(jm, jt, jstate, pipe, 1, start=2)
    state, mets = _port_run(cfg, tc, state, pipe, 1, start=2)
    _assert_metrics(mets, jmets)
    _assert_states(state, jstate, compress=True)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_moe_kernel_calls_per_step(monkeypatch, remat):
    """The counts of `test_torch_train.test_kernel_calls_per_step` for the
    MoE block; `chip_smoke.py` asserts them for the kernels' launches."""
    _, cfg = _cfgs("olmoe-1b-7b", remat=remat)
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


def test_moe_bf16_state_keeps_the_router_f32():
    """A bf16 MoE state: the router and every moment f32, the rest bf16;
    it goes to the JAX layout and back unchanged."""
    cfg = reduced(get_arch("olmoe-1b-7b"))
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    state = train_state_init({n: p.detach() for n, p in
                              m.named_parameters()}, tc)
    state, met = make_train_step(m, tc)(
        state, TokenPipeline(cfg.vocab, 2, 32).batch_at(0))
    assert np.isfinite(float(met["loss"]))
    for n, p in state.params.items():
        want = torch.float32 if n.endswith(".router") else torch.bfloat16
        assert p.dtype == want, n
        assert state.opt.mu[n].dtype == torch.float32
    back = train_state_from_numpy(train_state_to_numpy(state), cfg, "cpu")
    for n, p in state.params.items():
        assert back.params[n].dtype == p.dtype and torch.equal(
            back.params[n], p), n
        assert torch.equal(back.opt.nu[n], state.opt.nu[n]), n


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_launch_train_moe_on_cpu(capsys, name):
    from repro_torch.launch.train import main
    final = main(["--arch", name, "--reduced", "--steps", "20",
                  "--batch", "8", "--seq", "32", "--lr", "3e-3",
                  "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = _printed_losses(out)
    assert f"arch={name} " in out
    assert len(losses) == 20 and losses[-1] == pytest.approx(final, abs=1e-4)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_launch_serve_moe_on_cpu(name):
    from repro_torch.launch.serve import main
    done = main(["--arch", name, "--reduced", "--device", "cpu",
                 "--requests", "3", "--slots", "2", "--prompt-len", "4",
                 "--max-new", "3", "--cache-len", "16"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert all(0 <= t < reduced(get_arch(name)).vocab
               for r in done for t in r.out)
