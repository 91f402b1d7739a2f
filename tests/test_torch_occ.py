"""The port's `core/occ.py` mechanism against the JAX package, on the CPU.

Each test feeds the same numpy arrays to the JAX function and to its port
(`device="cpu"`).  The validators do no arithmetic on the distances they
are given (min, compare, select, one copy of the payload), so every output,
centers included, must be bit-identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import DPMeansTransaction as JTxn  # noqa: E402
from repro.core import occ as jocc  # noqa: E402
from repro_torch.convert import pool_from_numpy, pool_to_numpy  # noqa: E402
from repro_torch.core import DPMeansTransaction as TTxn  # noqa: E402
from repro_torch.core import occ as tocc  # noqa: E402

LAM = 1.0


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_pools_equal(jp, tp):
    tn = pool_to_numpy(tp)
    for f in ("centers", "mask", "count", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)), tn[f], err_msg=f)


def _pools(k_max, d, count0, seed):
    rng = np.random.default_rng(seed)
    centers = np.zeros((k_max, d), np.float32)
    centers[:count0] = rng.normal(size=(count0, d)).astype(np.float32) * 3
    mask = np.arange(k_max) < count0
    jp = jocc.CenterPool(jnp.asarray(centers), jnp.asarray(mask),
                         jnp.asarray(count0, jnp.int32), jnp.asarray(False))
    tp = pool_from_numpy(centers, mask, count0, False, device="cpu")
    return jp, tp, centers


def test_make_pool_and_append_serial_match_jax():
    jp = jocc.make_pool(4, 3)
    tp = tocc.make_pool(4, 3, device="cpu")
    _assert_pools_equal(jp, tp)
    rng = np.random.default_rng(0)
    for do in (True, False, True, True, True, True):   # the last two overflow
        x = rng.normal(size=3).astype(np.float32)
        jp, js = jocc.pool_append_serial(jp, jnp.asarray(x), jnp.asarray(do))
        tp, ts = tocc.pool_append_serial(tp, torch.from_numpy(x),
                                         torch.tensor(do))
        assert int(js) == int(ts) and ts.dtype == torch.int32
        _assert_pools_equal(jp, tp)
    assert bool(tp.overflow) and int(tp.count) == 4


@pytest.mark.parametrize("cap", [5, 16, 40])
def test_compact_sent_and_scatter_back_match_jax(cap):
    rng = np.random.default_rng(cap)
    b = 32
    send = rng.uniform(size=b) < 0.3
    jo, jovf = jocc._compact_sent(jnp.asarray(send), min(cap, b))
    to, tovf = tocc._compact_sent(torch.from_numpy(send), min(cap, b))
    np.testing.assert_array_equal(np.asarray(jo), _np(to))
    assert bool(jovf) == bool(tovf) == (cap < b and send.sum() > cap)
    slots_c = rng.integers(-1, 9, size=len(jo)).astype(np.int32)
    refs_c = rng.integers(0, 9, size=len(jo)).astype(np.int32)
    js, jr = jocc._scatter_back(jo, b, jnp.asarray(slots_c), jnp.asarray(refs_c))
    ts, tr = tocc._scatter_back(to, b, torch.from_numpy(slots_c),
                                torch.from_numpy(refs_c))
    np.testing.assert_array_equal(np.asarray(js), _np(ts))
    np.testing.assert_array_equal(np.asarray(jr), _np(tr))


@pytest.mark.parametrize("scan_mode", ["serial", "logdepth"])
@pytest.mark.parametrize("k_max", [64, 14])    # 14: the pool overflows
def test_validators_match_jax(scan_mode, k_max):
    d, cap, count0 = 8, 48, 10
    jp, tp, centers = _pools(k_max, d, count0, seed=k_max)
    rng = np.random.default_rng(1)
    # half the payloads near an existing center, half in fresh clusters
    near = centers[rng.integers(0, count0, size=cap // 2)] \
        + 0.2 * rng.normal(size=(cap // 2, d))
    far = np.repeat(rng.normal(size=(6, d)) * 8, cap // 12, axis=0) \
        + 0.3 * rng.normal(size=(cap // 2, d))
    payload = np.concatenate([near, far]).astype(np.float32)
    payload = payload[rng.permutation(cap)]
    send = rng.uniform(size=cap) < 0.8

    jt, tt = JTxn(LAM, k_max), TTxn(LAM, k_max)
    d2s, idxs = jocc.nearest_center(jp, jnp.asarray(payload))
    jpre = jt.precompute_accept(jp, jnp.asarray(payload), (d2s, idxs), jp.count)
    tpre = tocc.ValidatePre(*(torch.from_numpy(np.array(a)) for a in
                              (jpre.d2_start, jpre.idx_start, jpre.pair_d2)),
                            None)
    jval = dict(serial=jocc.precomputed_validate,
                logdepth=jocc.logdepth_validate)[scan_mode]
    tval = dict(serial=tocc.precomputed_validate,
                logdepth=tocc.logdepth_validate)[scan_mode]
    jpool, jslots, jrefs = jval(jp, jnp.asarray(send), jnp.asarray(payload),
                                jpre, jt.accept_pre)
    tpool, tslots, trefs = tval(tp, torch.from_numpy(send),
                                torch.from_numpy(payload), tpre, tt.accept_pre)
    np.testing.assert_array_equal(np.asarray(jslots), _np(tslots))
    np.testing.assert_array_equal(np.asarray(jrefs), _np(trefs))
    assert tslots.dtype == torch.int32 and trefs.dtype == torch.int32
    _assert_pools_equal(jpool, tpool)
    assert bool(tpool.overflow) == (k_max == 14)
    # the input pool is left as it was
    np.testing.assert_array_equal(tp.centers.numpy(), centers)
    assert int(tp.count) == count0


def test_gather_validate_and_nearest_center_match_jax():
    k_max, d, b = 32, 6, 40
    jp, tp, centers = _pools(k_max, d, 5, seed=3)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(b, d)) * 4).astype(np.float32)
    jd2, jidx = jocc.nearest_center(jp, jnp.asarray(x))
    td2, tidx = tocc.nearest_center(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jidx), _np(tidx))
    np.testing.assert_allclose(np.asarray(jd2), _np(td2), rtol=1e-5, atol=1e-5)
    jt, tt = JTxn(LAM, k_max), TTxn(LAM, k_max)
    send = np.asarray(jd2) > LAM ** 2
    for cap in (None, 8):
        jout = jocc.precomputed_gather_validate(
            jp, jnp.asarray(send), jnp.asarray(x), (jd2, jidx),
            jt.precompute_accept, jt.accept_pre, cap=cap)
        tout = tocc.precomputed_gather_validate(
            tp, torch.from_numpy(send), torch.from_numpy(x),
            (torch.from_numpy(np.array(jd2)), torch.from_numpy(np.array(jidx))),
            tt.precompute_accept, tt.accept_pre, cap=cap)
        _assert_pools_equal(jout[0], tout[0])
        for a, b_ in zip(jout[1:], tout[1:]):
            np.testing.assert_array_equal(np.asarray(a), _np(b_))
