"""OFL in the port against the JAX package, and the port's own bitwise
invariants, on the CPU (`device="cpu"`).

Bar between the packages: the uniforms bit for bit; labels, sends, epochs,
OCCStats and K identical; centers bitwise (they are copies of points).
Inside the port every invariant is bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (  # noqa: E402
    OCCEngine, OFLTransaction, occ_ofl, point_uniforms, serial_ofl,
)
from repro_torch.core._reference import reference_pass  # noqa: E402
from repro_torch.data import dp_stick_breaking_data  # noqa: E402

LAM = 4.0


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _key(seed):
    """(typed JAX key, its raw key data as numpy uint32)."""
    key = jax.random.key(seed)
    return key, np.asarray(jax.random.key_data(key))


def _assert_results_match(jr, tr, z="assign"):
    for f in (z, "send", "epoch_of"):
        np.testing.assert_array_equal(_np(getattr(jr, f)),
                                      _np(getattr(tr, f)), err_msg=f)
    for f in ("proposed", "accepted", "cap"):
        np.testing.assert_array_equal(_np(getattr(jr.stats, f)),
                                      _np(getattr(tr.stats, f)), err_msg=f)
    for f in ("centers", "mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jr.pool, f)),
                                      _np(getattr(tr.pool, f)), err_msg=f)


def _bitwise(a, b):
    return all(torch.equal(u, v) for u, v in
               ((a.assign, b.assign), (a.send, b.send),
                (a.epoch_of, b.epoch_of), (a.stats.proposed, b.stats.proposed),
                (a.stats.accepted, b.stats.accepted), *zip(a.pool, b.pool)))


# ------------------------------------------------------------- the uniforms

def test_threefry_partitionable_is_on():
    """The port reproduces the uniforms of jax's partitionable threefry; a
    jax whose default differs must fail here, not drift silently."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("n,offset", [(3000, 0), (3000, 500), (64, 2**31 - 7),
                                      (64, 2**32 - 5)])
def test_point_uniforms_bitwise(seed, n, offset):
    """Every bit, for several keys and offsets; offsets wrap at 2^32 (the
    JAX package takes one past 2^31 as a uint32)."""
    key, kd = _key(seed)
    ju = _np(jcore.point_uniforms(key, n, np.uint32(offset)))
    tu = point_uniforms(kd, n, offset, device="cpu")
    assert tu.dtype == torch.float32 and tu.shape == (n,)
    np.testing.assert_array_equal(ju.view(np.uint32), _np(tu).view(np.uint32))


def test_point_uniforms_key_forms_and_range():
    _, kd = _key(3)
    ref = point_uniforms(kd, 100, 9, device="cpu")
    for key in ((0, 3), [0, 3], torch.tensor([0, 3], dtype=torch.int32),
                np.array([0, 3], np.int64)):
        assert torch.equal(point_uniforms(key, 100, 9, device="cpu"), ref)
    u = point_uniforms((5, 6), 10_000, device="cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # counter-based: a slice of a longer draw is the shorter draw
    assert torch.equal(point_uniforms(kd, 40, 60, device="cpu"),
                       point_uniforms(kd, 100, 0, device="cpu")[60:])


# ------------------------------------------------------ the port against JAX

@pytest.mark.parametrize("cap", [None, 32, "adaptive"])
@pytest.mark.parametrize("pb,seed", [(16, 0), (64, 1), (128, 2)])
def test_occ_ofl_matches_jax(pb, seed, cap):
    x, _, _ = dp_stick_breaking_data(512, seed=seed)
    key, kd = _key(seed)
    jr = jcore.occ_ofl(jnp.asarray(x), LAM, pb=pb, key=key, k_max=256,
                       validate_cap=cap)
    tr = occ_ofl(x, LAM, pb=pb, key=kd, k_max=256, validate_cap=cap,
                 device="cpu")
    _assert_results_match(jr, tr, z="z")
    np.testing.assert_allclose(float(jr.objective), float(tr.objective),
                               rtol=1e-5)


@pytest.mark.parametrize("scan_mode,cap,nb", [
    ("serial", None, 0), ("logdepth", None, 0), ("serial", "adaptive", 8),
    ("logdepth", 24, 8),
])
def test_engine_two_passes_match_jax(scan_mode, cap, nb):
    """A pass (with a bootstrap prefix) and a warm pass from the JAX pool
    carried across, in both packages."""
    x, _, _ = dp_stick_breaking_data(640, seed=3)
    key, kd = _key(11)
    je = jcore.OCCEngine(jcore.OFLTransaction(LAM, 256, key), 64,
                         validate_cap=cap, scan_mode=scan_mode)
    te = OCCEngine(OFLTransaction(LAM, 256, kd), 64, validate_cap=cap,
                   scan_mode=scan_mode, device="cpu")
    jx = jnp.asarray(x)
    jr = je.run(jx, n_bootstrap=nb)
    _assert_results_match(jr, te.run(x, n_bootstrap=nb))
    tpool = convert.pool_from_numpy(*(np.asarray(a) for a in jr.pool),
                                    device="cpu")
    _assert_results_match(je.run(jx, pool=jr.pool), te.run(x, pool=tpool))
    assert je.cap_history == te.cap_history


def test_serial_ofl_matches_jax():
    x, _, _ = dp_stick_breaking_data(384, seed=4)
    key, kd = _key(5)
    u = np.array(jcore.point_uniforms(key, x.shape[0]))
    jpool, jz = jcore.serial_ofl(jnp.asarray(x), jnp.asarray(u), LAM, 256)
    tpool, tz = serial_ofl(x, u, LAM, 256, device="cpu")
    np.testing.assert_array_equal(_np(jz), _np(tz))
    for f in ("centers", "mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jpool, f)),
                                      _np(getattr(tpool, f)), err_msg=f)


# ------------------------------------------------- inside the port, bitwise

@pytest.mark.parametrize("pb,seed", [(16, 0), (64, 1), (128, 2)])
def test_occ_equals_serial_along_epoch_order(pb, seed):
    """Thm 3.1 for OFL: the OCC run equals serial OFL over the points in
    epoch-then-index order with the same uniforms: K and centers."""
    x, _, _ = dp_stick_breaking_data(512, seed=seed)
    kd = (0, seed)
    res = occ_ofl(x, LAM, pb=pb, key=kd, k_max=256, device="cpu")
    u = point_uniforms(kd, x.shape[0], device="cpu")
    order = torch.from_numpy(np.lexsort((np.arange(512),
                                         res.epoch_of.numpy())))
    pool_s, _ = serial_ofl(torch.from_numpy(x)[order], u[order], LAM, 256,
                           device="cpu")
    k = int(res.pool.count)
    assert int(pool_s.count) == k
    assert torch.equal(pool_s.centers[:k], res.pool.centers[:k])


@pytest.mark.parametrize("cuts", [[100, 137, 412], [63, 64, 65], [1], [511]])
def test_stream_any_batching_bit_identical(cuts):
    """Counter-based uniforms + probabilistic sends: any drift of the epoch
    partition would change draws."""
    x, _, _ = dp_stick_breaking_data(512, seed=5, dim=8)
    txn = OFLTransaction(LAM, 256, (0, 9))
    one = OCCEngine(txn, 64, device="cpu").run(x)
    eng = OCCEngine(txn, 64, device="cpu")
    parts = [eng.partial_fit(xb) for xb in np.split(x, cuts)]
    parts.append(eng.flush())
    parts = [p for p in parts if p is not None]
    assert parts[0].assign.dtype == torch.int32
    for f in ("assign", "epoch_of", "send"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                           getattr(one, f)), f
    assert all(torch.equal(a, b) for a, b in zip(eng.pool, one.pool))
    assert torch.equal(eng.stats.proposed, one.stats.proposed)
    assert torch.equal(eng.stats.accepted, one.stats.accepted)


def test_adaptive_and_logdepth_equal_serial_full_cap():
    x, _, _ = dp_stick_breaking_data(768, seed=6)
    txn = OFLTransaction(3.0, 512, (0, 3))

    def three(**kw):
        eng = OCCEngine(txn, 64, device="cpu", **kw)
        r = [eng.run(x)]
        for _ in range(2):          # warm passes: the shrunken cap is live
            r.append(eng.run(x, pool=r[-1].pool))
        return r, eng
    base, _ = three()
    for kw in (dict(validate_cap="adaptive"), dict(scan_mode="logdepth"),
               dict(validate_cap="adaptive", scan_mode="logdepth")):
        other, eng = three(**kw)
        assert all(_bitwise(a, b) for a, b in zip(base, other)), kw
    assert eng.cap_history[-1] is not None and eng.cap_history[-1] < 64


SWEEP = [
    # (n, d, k_max, k0, pb, lam, cap), as the JAX package's validator sweep
    (48, 3, 16, 0, 8, 2.0, None),
    (48, 3, 16, 5, 8, 2.0, 16),
    (96, 5, 64, 8, 16, 0.8, 4),
    (24, 2, 16, 2, 32, 4.0, 4),
    (96, 5, 8, 0, 16, 0.5, None),
]


@pytest.mark.parametrize("n,d,k_max,k0,pb,lam,cap", SWEEP)
def test_fast_validator_equals_reference_pass(n, d, k_max, k0, pb, lam, cap):
    rng = np.random.default_rng(n + k0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 2.0)
    centers = np.zeros((k_max, d), np.float32)
    k0 = min(k0, k_max)
    centers[:k0] = rng.normal(size=(k0, d)).astype(np.float32) * 2.0
    pool = convert.pool_from_numpy(centers, np.arange(k_max) < k0, k0, False,
                                   device="cpu")
    txn = OFLTransaction(lam, k_max, (0, n))
    fast = OCCEngine(txn, pb, validate_cap=cap, device="cpu").run(x, pool=pool)
    rp, ra, rs, rst = reference_pass(txn, pool, x, pb=pb, cap=cap)
    assert torch.equal(fast.assign, ra) and torch.equal(fast.send, rs)
    assert all(torch.equal(a, b) for a, b in zip(fast.pool, rp))
    assert all(torch.equal(a, b) for a, b in zip(fast.stats, rst))


def test_first_epoch_all_sent():
    """Epoch 1 has no centers: everything goes to the validator."""
    x, _, _ = dp_stick_breaking_data(256, seed=5)
    res = occ_ofl(x, LAM, pb=64, key=(0, 0), k_max=256, device="cpu")
    assert int(res.stats.proposed[0]) == 64


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    x, _, _ = dp_stick_breaking_data(64, seed=0)
    u = np.zeros(8, np.float32)
    for call in (lambda: occ_ofl(x, LAM, 16, (0, 0)),
                 lambda: serial_ofl(x[:8], u, LAM, 16),
                 lambda: point_uniforms((0, 0), 8),
                 lambda: OCCEngine(OFLTransaction(LAM, 16, (0, 0)), 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
