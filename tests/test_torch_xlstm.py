"""The port's mLSTM and sLSTM blocks and the xLSTM family (xlstm-1.3b)
against the JAX package, on the CPU.

The same numpy inputs and weights go through the JAX function and the
port's, in f32 at `reduced(xlstm-1.3b)`:

  * `mlstm_train` (chunks of 16, and a length the chunk does not divide)
    and `slstm_train`: outputs, final states and the VJP within 1e-5 of
    the largest magnitude; `mlstm_decode` and `slstm_decode` chained
    token by token against the JAX decode within 1e-6, and the sLSTM's
    chain against `slstm_train` within 1e-5 (the mLSTM's chunked form is
    held to its decode through the model, decode after a prefill);
  * the model, with the helpers and bars of `test_torch_ssm.py`: prefill
    logits and caches, decode_step over positions 0 to 40, decode after a
    prefill against the longer prefill (2e-3), loss and gradients, one
    `adamw_update` within one f32 ulp and its decay rule (one-layer
    segments are not stacked, so their norms do not decay; a stacked
    mLSTM segment's do), five train steps, a checkpoint across the
    packages, the serving engines' tokens, the full config's
    `param_count`, and the launchers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as jx  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from test_torch_ssm import (  # noqa: E402
    _cfgs, _close, _t, check_adamw_update, check_checkpoint_across_packages,
    check_decode_chain, check_decode_matches_forward, check_engine_tokens,
    check_launchers, check_loss_and_gradients, check_param_count_full,
    check_prefill, check_train_steps,
)

ARCH = "xlstm-1.3b"


def _weights(kind, seed=0):
    jcfg, cfg = _cfgs(ARCH)
    init = jx.init_mlstm if kind == "mlstm" else jx.init_slstm
    p = jax.tree.map(np.asarray, init(jax.random.key(seed), jcfg))
    return jcfg, cfg, p, np.random.default_rng(seed)


@pytest.mark.parametrize("kind,s", [("mlstm", 64), ("mlstm", 40),
                                    ("slstm", 24)])
def test_train_and_vjp_match_jax(kind, s):
    jcfg, cfg, p, rng = _weights(kind)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    jfn = jx.mlstm_train if kind == "mlstm" else jx.slstm_train
    tfn = xlstm.mlstm_train if kind == "mlstm" else xlstm.slstm_train

    def jf(p, x):
        out, st = jfn(p, x, jcfg, None)
        return jnp.sum(out * dy), (out, st)
    (_, (jo, js)), (jgp, jgx) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x))
    tp = {k: _t(v, True) for k, v in p.items()}
    tx = _t(x, True)
    to, ts = tfn(tp, tx, cfg)
    (to * _t(dy)).sum().backward()
    _close(to.detach().numpy(), jo, 1e-5, "out")
    assert sorted(ts) == sorted(js)
    for k in js:
        _close(ts[k].detach().numpy(), js[k], 1e-5, k)
    for k in p:
        _close(tp[k].grad.numpy(), jgp[k], 1e-5, f"d{k}")
    _close(tx.grad.numpy(), jgx, 1e-5, "dx")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_chained(kind):
    jcfg, cfg, p, rng = _weights(kind, seed=3)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    init = xlstm.init_mlstm_cache if kind == "mlstm" \
        else xlstm.init_slstm_cache
    dec = xlstm.mlstm_decode if kind == "mlstm" else xlstm.slstm_decode
    jdec = jx.mlstm_decode if kind == "mlstm" else jx.slstm_decode
    jinit = jx.init_mlstm_cache if kind == "mlstm" else jx.init_slstm_cache
    cache = init(cfg, 2, device="cpu")
    jc = jinit(jcfg, 2)
    jp = jax.tree.map(jnp.asarray, p)
    outs, jouts = [], []
    with torch.no_grad():
        for i in range(12):
            outs.append(dec(tp, _t(x[:, i:i + 1]), cfg, cache))
            jo, jc = jdec(jp, jnp.asarray(x[:, i:i + 1]), jcfg, jc, None)
            jouts.append(np.asarray(jo))
    got = torch.cat(outs, 1).numpy()
    _close(got, np.concatenate(jouts, 1), 1e-6, "against the JAX decode")
    for k in jc:
        _close(cache[k].numpy(), jc[k], 1e-6, f"state {k}")
    if kind == "slstm":
        with torch.no_grad():
            want, st = xlstm.slstm_train(tp, _t(x), cfg)
        _close(got, want.numpy(), 1e-5, "against slstm_train")
        for k in st:
            _close(cache[k].numpy(), st[k].numpy(), 1e-5, f"state {k}")


def test_xlstm_prefill_and_caches_match_jax():
    check_prefill(ARCH)


def test_xlstm_decode_step_matches_jax_at_positions_0_to_40():
    check_decode_chain(ARCH)


def test_xlstm_decode_matches_forward():
    check_decode_matches_forward(ARCH)


def test_xlstm_loss_and_gradients_match_jax():
    check_loss_and_gradients(ARCH)


@pytest.mark.parametrize("n_layers,every", [(4, 2), (6, 3)])
def test_xlstm_adamw_update_matches_jax_leaf_by_leaf(n_layers, every):
    # (4, 2): mlstm, slstm, mlstm, slstm, each one layer, none stacked;
    # (6, 3): mlstm x2 (stacked), slstm, mlstm x2, slstm
    segs = ["seg_00", "seg_01", "seg_02", "seg_03"]
    flat = {f"segments/{seg}/norm1" for seg in segs}
    if every == 3:
        flat -= {"segments/seg_00/norm1", "segments/seg_02/norm1"}
    check_adamw_update(ARCH, flat | {"final_norm"}, n_layers=n_layers,
                       slstm_every=every)


def test_xlstm_train_steps_match_jax():
    check_train_steps(ARCH)


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_xlstm_checkpoint_restores_across_packages(tmp_path, saver):
    check_checkpoint_across_packages(tmp_path, ARCH, saver)


def test_xlstm_serve_engine_tokens_identical_to_jax():
    check_engine_tokens(ARCH)


def test_xlstm_param_count_full_on_meta():
    check_param_count_full(ARCH, 1.0e9, 1.9e9)


def test_xlstm_launchers_run_on_cpu(capsys):
    check_launchers(capsys, ARCH)
