"""The port's Mixture-of-Experts FFN against the JAX package's, on the CPU.

Both packages run the same f32 weights (the JAX package's `init_moe`,
carried across as numpy) on the same numpy activations, at
`reduced(olmoe-1b-7b)` (E 4, top-2) and at a narrow config with the full
router of olmoe-1b-7b (E 64, top-8, d 64), so that the order of eight of
sixty-four is tested:

  * the router: top-k ids identical, probabilities within 1e-6, ties to
    the lower expert as `lax.top_k` breaks them;
  * `_capacity_slots` on the same router outputs: source token, filled
    and gate weight identical at capacity factors 1.0, 1.25 and 8.0 (the
    reduced config's own 2.0 drops nothing, since C = S there);
  * each of the five impls against the JAX package's same impl within
    1e-5 of the output's largest magnitude, and against the port's
    `dense` at capacity factor 8 (no drops) within 1e-4, as the JAX
    package's `tests/test_models_smoke.py` holds its own;
  * the VJPs of each impl (with respect to the input and every weight)
    against `jax.vjp`, within 1e-4 of each gradient's largest magnitude;
  * `active_params` (the model-FLOP count of `chip_smoke.py`) equal to the
    JAX package's `roofline.active_params`.

The port runs on the CPU here, where `ops.swiglu` takes its plain
version; `chip_smoke.py` drives the same functions through the swiglu
kernels on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import MoEConfig, get_arch, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

IMPLS = ["dense", "capacity", "gather", "ragged", "hybrid"]
CONFIGS = ["reduced", "narrow"]
IMPL_RTOL = 1e-5      # against the JAX package's same impl
ORACLE_ATOL = 1e-4    # against the port's dense impl, no drops
VJP_RTOL = 1e-4


def _cfgs(which: str, **moe_kw):
    """(JAX config, port config) in f32."""
    jcfg = jreduced(JARCHS["olmoe-1b-7b"]).replace(dtype="float32")
    cfg = reduced(get_arch("olmoe-1b-7b")).replace(dtype="float32")
    if which == "narrow":
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, n_experts=64,
                                                    top_k=8))
        cfg = cfg.replace(moe=MoEConfig(n_experts=64, top_k=8,
                                        capacity_factor=2.0))
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _weights(jcfg, seed=0):
    """(JAX weights, the same as port tensors)."""
    p = jmoe.init_moe(jax.random.key(seed), jcfg)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("which", CONFIGS)
def test_router_matches_jax(which):
    jcfg, cfg = _cfgs(which)
    jp, tp = _weights(jcfg)
    x = _x(cfg, s=64)
    jpr, jid = jmoe._router(jp, jnp.asarray(x), jcfg)
    tpr, tid = moe._router(tp, torch.from_numpy(x), cfg)
    assert tid.shape == (2, 64, cfg.moe.top_k)
    assert np.array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), atol=1e-6,
                               rtol=0)
    assert tpr.dtype == torch.float32


def test_router_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both
    packages pick experts 0..k-1 in order; equal pairs among distinct
    logits keep index order too."""
    jcfg, cfg = _cfgs("narrow")
    jp, tp = _weights(jcfg)
    x = _x(cfg, b=1, s=4)
    zero = {**tp, "router": torch.zeros_like(tp["router"])}
    _, tid = moe._router(zero, torch.from_numpy(x), cfg)
    _, jid = jmoe._router({**jp, "router": jnp.zeros_like(jp["router"])},
                          jnp.asarray(x), jcfg)
    assert np.array_equal(np.asarray(jid), tid.numpy())
    assert tid[0, 0].tolist() == list(range(8))
    # experts in pairs of equal columns: (0, 1), (2, 3), ...
    paired = tp["router"].clone()
    paired[:, 1::2] = paired[:, 0::2]
    _, tid = moe._router({**tp, "router": paired}, torch.from_numpy(x), cfg)
    _, jid = jmoe._router({**jp, "router": jnp.asarray(paired.numpy())},
                          jnp.asarray(x), jcfg)
    assert np.array_equal(np.asarray(jid), tid.numpy())
    ids = tid.numpy()
    for a in range(0, 8, 2):     # a tied pair stays in index order
        assert (ids[..., a] + 1 == ids[..., a + 1]).all()


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
@pytest.mark.parametrize("which", CONFIGS)
def test_capacity_slots_identical_to_jax(which, cf):
    jcfg, cfg = _cfgs(which, capacity_factor=cf)
    jp, _ = _weights(jcfg)
    x = _x(cfg, s=32, seed=3)
    jpr, jid = jmoe._router(jp, jnp.asarray(x), jcfg)
    e, s = cfg.moe.n_experts, x.shape[1]
    cap = moe.capacity(cfg, s)
    jsrc, jhit, jw = jmoe._capacity_slots(jpr, jid, e, cap)
    tsrc, thit, tw = moe._capacity_slots(torch.from_numpy(np.array(jpr)),
                                         torch.from_numpy(np.array(jid))
                                         .long(), e, cap)
    assert tsrc.shape == (2, e, cap)
    assert np.array_equal(tsrc.numpy(), np.asarray(jsrc))
    assert np.array_equal(thit.numpy(), np.asarray(jhit))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    drops = 2 * s * cfg.moe.top_k - int(thit.sum())
    if cf == 8.0:
        assert drops == 0
    elif cf == 1.0:
        assert drops > 0          # the lowest factor drops tokens


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("which", CONFIGS)
def test_impl_matches_jax(which, impl):
    """At the config's capacity factor (2.0) and at 1.0, where the
    capacity impls drop tokens."""
    for cf in (2.0, 1.0):
        jcfg, cfg = _cfgs(which, impl=impl, capacity_factor=cf)
        jp, tp = _weights(jcfg, seed=1)
        x = _x(cfg, seed=1)
        want = np.asarray(jmoe.moe_apply(jp, jnp.asarray(x), jcfg, None))
        got = moe.moe_apply(tp, torch.from_numpy(x), cfg)
        assert got.shape == x.shape and got.dtype == torch.float32
        scale = float(np.abs(want).max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= IMPL_RTOL * scale, (cf, err, scale)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("which", CONFIGS)
def test_impl_matches_dense_oracle(which, impl):
    _, cfg = _cfgs(which, capacity_factor=8.0)
    jcfg, _ = _cfgs(which)
    _, tp = _weights(jcfg, seed=2)
    x = torch.from_numpy(_x(cfg, seed=2))
    dense = moe.moe_apply(tp, x, cfg.replace(
        moe=dataclasses.replace(cfg.moe, impl="dense")))
    got = moe.moe_apply(tp, x, cfg.replace(
        moe=dataclasses.replace(cfg.moe, impl=impl)))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ORACLE_ATOL,
                               rtol=0)


def test_unknown_impl_runs_capacity():
    """The reference's `moe_apply` falls through to `capacity` for any
    other name; so does the port."""
    jcfg, cfg = _cfgs("reduced")
    _, tp = _weights(jcfg)
    x = torch.from_numpy(_x(cfg))
    cap = moe.moe_apply(tp, x, cfg)
    other = moe.moe_apply(tp, x, cfg.replace(
        moe=dataclasses.replace(cfg.moe, impl="no-such-impl")))
    assert torch.equal(cap, other)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("which", CONFIGS)
def test_impl_vjp_matches_jax(which, impl):
    """d(out . cot) by x and by every weight, at capacity factor 1.0 (the
    capacity impls drop tokens, whose gradients are zero)."""
    jcfg, cfg = _cfgs(which, impl=impl, capacity_factor=1.0)
    jp, tp = _weights(jcfg, seed=4)
    x = _x(cfg, seed=4)
    cot = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda p, xx: jmoe.moe_apply(p, xx, jcfg, None),
                       jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = moe.moe_apply(leaves, tx, cfg)
    grads = torch.autograd.grad(tout, [tx, *leaves.values()],
                                torch.from_numpy(cot))
    want = {"x": np.asarray(jgx), **{k: np.asarray(v)
                                     for k, v in jgp.items()}}
    got = dict(zip(["x", *leaves], (g.numpy() for g in grads)))
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= VJP_RTOL * scale, (k, err, scale)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
                                  "qwen3-4b"])
def test_active_params_equal_jax(name):
    from repro.models import build_model as jbuild
    from repro.roofline import active_params as jactive
    from repro_torch.models import Model
    for layers in (None, 8):
        jcfg, cfg = JARCHS[name], get_arch(name)
        if layers:
            jcfg, cfg = (c.replace(n_layers=layers) for c in (jcfg, cfg))
        n = Model(cfg, device="meta").param_count()
        assert n == jbuild(jcfg).param_count()
        assert moe.active_params(cfg, n) == jactive(jcfg, n)
