"""BP-means in the port against the JAX package, and the port's own
invariants, on the CPU (`device="cpu"`).

Bar between the packages: assignments, sends, epochs, slots, OCCStats and
K identical; features within 1e-5 before a re-estimate and within the
reference's own 1e-4 after one (a ridge solve in two libraries differs in
the last bits).  Inside the port: decisions and every discrete output are
bitwise; features bitwise where the same arithmetic runs (cap settings,
batching), within 1e-4 where the serial pass's D-dimensional refit stands
against the Gram scan's coefficient algebra.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import occ as jocc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BPMeansTransaction, OCCEngine, ValidatePre, bp_means_objective,
    coordinate_pass, occ_bp_means, precomputed_validate_gram,
    serial_bp_means, serial_bp_means_pass, thm31_permutation,
)
from repro_torch.core._reference import reference_pass  # noqa: E402
from repro_torch.core.bp_means import _reestimate  # noqa: E402
from repro_torch.data import bp_stick_breaking_data  # noqa: E402

LAM = 4.0
FEAT = dict(rtol=0, atol=1e-5)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pools(k_max, d, k0, rng, scale=2.0):
    """The same pool in both packages: k0 random features."""
    centers = np.zeros((k_max, d), np.float32)
    centers[:k0] = rng.normal(size=(k0, d)).astype(np.float32) * scale
    mask = np.arange(k_max) < k0
    jp = jocc.CenterPool(jnp.asarray(centers), jnp.asarray(mask),
                         jnp.asarray(k0, jnp.int32), jnp.asarray(False))
    return jp, convert.pool_from_numpy(centers, mask, k0, False, device="cpu")


def _assert_decisions_match(jr, tr, z="assign"):
    for f in (z, "send", "epoch_of"):
        np.testing.assert_array_equal(_np(getattr(jr, f)),
                                      _np(getattr(tr, f)), err_msg=f)
    for f in ("proposed", "accepted", "cap"):
        a, b = getattr(jr.stats, f), getattr(tr.stats, f)
        if a is not None or b is not None:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)
    for f in ("mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jr.pool, f)),
                                      _np(getattr(tr.pool, f)), err_msg=f)


# ------------------------------------------------------ the port against JAX

@pytest.mark.parametrize("b,k_max,k0,masked", [
    (64, 32, 0, False), (64, 32, 9, False), (128, 64, 30, False),
    (40, 16, 12, True),
])
def test_coordinate_pass_matches_jax(b, k_max, k0, masked):
    """z identical, residual within 1e-5; the port's loop stops at the
    count, the reference scans all K_max slots."""
    rng = np.random.default_rng(b + k0)
    jp, tp = _pools(k_max, 6, k0, rng)
    x = rng.normal(size=(b, 6)).astype(np.float32) * 3.0
    z0 = rng.uniform(size=(b, k_max)) < 0.3
    fm = (np.arange(k_max) >= k0 // 2) & (np.arange(k_max) < k0) if masked \
        else None
    jz, jr = jcore.coordinate_pass(jnp.asarray(x), jnp.asarray(z0), jp,
                                   None if fm is None else jnp.asarray(fm))
    tz, tr = coordinate_pass(torch.from_numpy(x), torch.from_numpy(z0), tp,
                             None if fm is None else torch.from_numpy(fm))
    assert tz.dtype == torch.bool and tz.shape == (b, k_max)
    np.testing.assert_array_equal(_np(jz), _np(tz))
    np.testing.assert_allclose(_np(jr), _np(tr), **FEAT)


@pytest.mark.parametrize("k_max,k0,lam,cap", [
    (64, 3, 4.0, None),       # unbounded window, a few accepts
    (64, 0, 2.0, 24),         # cold pool, bounded window, many accepts
    (12, 8, 1.0, None),       # the pool fills: capacity overflow
])
def test_gram_scan_matches_jax_on_the_same_compacted_inputs(k_max, k0, lam,
                                                            cap):
    """One epoch's compacted proposals (JAX's propose, compaction and Gram
    matrix) through both scans: slots identical, the fit rows of sent
    proposals identical (unsent ones, which writeback discards, are all
    False in the port), features within 1e-5, pool flags identical."""
    rng = np.random.default_rng(k_max + k0)
    jp, tp = _pools(k_max, 8, k0, rng)
    x = jnp.asarray(rng.normal(size=(64, 8)).astype(np.float32) * 3.0)
    txn = jcore.BPMeansTransaction(lam, k_max, init_mean=False)
    send, payload, aux, _ = txn.propose(jp, x, txn.make_state(x))
    order, _ = jocc._compact_sent(send, cap or 64)
    send_c, payload_c = send[order], payload[order]
    pre = txn.precompute_accept(jp, payload_c, None, jp.count)
    jpool, jslots, jz = jocc.precomputed_validate_gram(
        jp, send_c, payload_c, pre, txn.accept_pre)
    ttxn = BPMeansTransaction(lam, k_max, init_mean=False)
    tsend = torch.from_numpy(np.array(send_c))
    tpool, tslots, tz = precomputed_validate_gram(
        tp, tsend, torch.from_numpy(np.array(payload_c)),
        ValidatePre(None, None, None, None,
                    gram=torch.from_numpy(np.array(pre.gram))),
        ttxn.accept_pre)
    assert int(tsend.sum()) > 4 and tslots.dtype == torch.int32
    np.testing.assert_array_equal(_np(jslots), _np(tslots))
    sent = _np(tsend)
    np.testing.assert_array_equal(_np(jz)[sent], _np(tz)[sent])
    assert not bool(tz[~tsend].any())
    for f in ("mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jpool, f)),
                                      _np(getattr(tpool, f)), err_msg=f)
    np.testing.assert_allclose(_np(jpool.centers), _np(tpool.centers), **FEAT)
    if k_max == 12:
        assert bool(tpool.overflow) and int(tpool.count) == 12


@pytest.mark.parametrize("pb,cap,bootstrap", [
    (32, None, False), (64, None, False), (32, "adaptive", True),
    (64, 16, False),
])
def test_occ_bp_means_one_pass_matches_jax(pb, cap, bootstrap):
    x, _, _ = bp_stick_breaking_data(384, seed=2)
    jr = jcore.occ_bp_means(jnp.asarray(x), LAM, pb, k_max=64, max_iters=1,
                            bootstrap=bootstrap, validate_cap=cap)
    tr = occ_bp_means(x, LAM, pb, k_max=64, max_iters=1, bootstrap=bootstrap,
                      validate_cap=cap, device="cpu")
    _assert_decisions_match(jr, tr, z="z")
    assert tr.z.dtype == torch.bool and tr.z.shape == (384, 64)
    assert jr.n_iters == tr.n_iters == 1
    # after the wrapper's one re-estimate
    np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("lam,cap", [(LAM, None), (2.0, "adaptive")])
def test_engine_passes_match_jax_with_the_pool_carried(lam, cap):
    """Pass, refine, pass, ... in both packages; each pass starts from the
    JAX package's refined pool and assignment, so both see the same bits."""
    x, _, _ = bp_stick_breaking_data(256, seed=4)
    jx = jnp.asarray(x)
    je = jcore.OCCEngine(jcore.BPMeansTransaction(lam, 128), 64,
                         validate_cap=cap)
    te = OCCEngine(BPMeansTransaction(lam, 128), 64, validate_cap=cap,
                   device="cpu")
    jpool, jz = None, je.txn.make_state(jx)
    for _ in range(3):
        tpool = None if jpool is None else convert.pool_from_numpy(
            *(np.asarray(a) for a in jpool), device="cpu")
        jr = je.run(jx, pool=jpool, state=jz)
        tr = te.run(x, pool=tpool, state=torch.from_numpy(np.array(jz)))
        _assert_decisions_match(jr, tr)
        np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers),
                                   **FEAT)
        jpool = je.refine(jr.pool, jx, jr.assign)
        np.testing.assert_allclose(
            _np(jpool.centers), _np(te.refine(tr.pool, x, tr.assign).centers),
            rtol=0, atol=1e-4)
        jz = jr.assign
    assert je.cap_history == te.cap_history


def test_serial_bp_means_and_objective_match_jax():
    x, _, _ = bp_stick_breaking_data(256, seed=5)
    jr = jcore.serial_bp_means(jnp.asarray(x), LAM, k_max=64, max_iters=3)
    tr = serial_bp_means(x, LAM, k_max=64, max_iters=3, device="cpu")
    np.testing.assert_array_equal(_np(jr.z), _np(tr.z))
    assert int(jr.pool.count) == int(tr.pool.count)
    assert jr.n_iters == tr.n_iters
    np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(jr.objective), float(tr.objective),
                               rtol=1e-4)
    # the objective itself on the same inputs
    feats, mask, z = (np.array(jr.pool.centers), np.array(jr.pool.mask),
                      np.array(jr.z))
    for m in (mask, None):
        want = float(jcore.bp_means_objective(
            jnp.asarray(x), jnp.asarray(z), jnp.asarray(feats), LAM,
            None if m is None else jnp.asarray(m)))
        got = float(bp_means_objective(
            torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(feats),
            LAM, None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ------------------------------------------------- inside the port, bitwise

@pytest.mark.parametrize("pb", [32, 64])
def test_serializability_exact(pb):
    """App. B.2: the OCC pass equals the serial pass along the Thm-3.1
    permutation, given the same initial pool (the engine seeds init_mean
    from the first Pb block)."""
    x, _, _ = bp_stick_breaking_data(256, seed=2)
    xt = torch.from_numpy(x)
    res = occ_bp_means(x, LAM, pb=pb, k_max=64, max_iters=1, device="cpu")
    perm = torch.from_numpy(thm31_permutation(res, x.shape[0]))
    txn = BPMeansTransaction(LAM, 64, init_mean=True)
    pool_s, z_s = serial_bp_means_pass(xt[perm], LAM, 64,
                                       pool=txn.init_pool(xt[:pb]),
                                       z=txn.make_state(xt), device="cpu")
    k = int(res.pool.count)
    assert int(pool_s.count) == k
    assert torch.equal(z_s, res.z[perm])
    pool_s = _reestimate(xt[perm], z_s, pool_s)
    np.testing.assert_allclose(_np(pool_s.centers[:k]),
                               _np(res.pool.centers[:k]), rtol=0, atol=1e-4)


def _stream(eng, x, cuts):
    parts = [eng.partial_fit(xb) for xb in np.split(x, cuts)]
    parts.append(eng.flush())
    return [p for p in parts if p is not None]


@pytest.mark.parametrize("cuts", [[50, 81, 200], [1], [31, 32, 33], [255]])
def test_stream_init_mean_bit_identical(cuts):
    """The (N, K_max) state rides the partial-epoch carry, and init_mean
    seeds from the first committed epoch in both modes."""
    x, _, _ = bp_stick_breaking_data(256, seed=2)
    txn = BPMeansTransaction(LAM, k_max=32, init_mean=True)
    one = OCCEngine(txn, 32, device="cpu").run(x)
    eng = OCCEngine(txn, 32, device="cpu")
    parts = _stream(eng, x, cuts)
    for f in ("assign", "epoch_of", "send"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                           getattr(one, f)), f
    assert all(torch.equal(a, b) for a, b in zip(eng.pool, one.pool))
    assert torch.equal(eng.stats.proposed, one.stats.proposed)


def test_carry_only_call_returns_an_empty_2d_assignment():
    x, _, _ = bp_stick_breaking_data(40, seed=3)
    eng = OCCEngine(BPMeansTransaction(LAM, 16), 32, device="cpu")
    res = eng.partial_fit(x[:7])
    assert res.assign.shape == (0, 16) and res.assign.dtype == torch.bool
    one = OCCEngine(BPMeansTransaction(LAM, 16), 32, device="cpu").run(x)
    rest = [eng.partial_fit(x[7:]), eng.flush()]
    assert torch.equal(torch.cat([r.assign for r in rest]), one.assign)


def test_multipass_stats_accumulate():
    x, _, _ = bp_stick_breaking_data(256, seed=4)
    t = 256 // 64
    r1 = occ_bp_means(x, 2.0, pb=64, k_max=128, max_iters=1, device="cpu")
    r3 = occ_bp_means(x, 2.0, pb=64, k_max=128, max_iters=3, device="cpu")
    assert r3.stats.proposed.shape == (t * r3.n_iters,)
    assert torch.equal(r3.stats.proposed[:t], r1.stats.proposed)
    assert r3.n_iters > 1 and int(r3.epoch_of.max()) == t * r3.n_iters - 1


def test_adaptive_cap_equals_full_cap():
    """Multi-pass so the Thm-3.3 estimate engages after the burn-in pass:
    committed results bitwise, features included."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.normal(size=(256, 4)).astype(np.float32) * 2.0)
    txn = BPMeansTransaction(3.0, 128, init_mean=False)
    state = txn.make_state(x)
    ea = OCCEngine(txn, 64, validate_cap="adaptive", device="cpu")
    ef = OCCEngine(txn, 64, device="cpu")
    ra, rf = ea.run(x, state=state), ef.run(x, state=state)
    for _ in range(2):
        ra = ea.run(x, pool=ra.pool, state=state)
        rf = ef.run(x, pool=rf.pool, state=state)
        assert torch.equal(ra.assign, rf.assign)
        assert all(torch.equal(a, b) for a, b in zip(ra.pool, rf.pool))
        assert torch.equal(ra.stats.proposed, rf.stats.proposed)
    assert ea.cap_history[-1] is not None and ea.cap_history[-1] < 64


SWEEP = [
    # (n, d, k_max, k0, pb, lam, cap), the JAX package's validator sweep:
    # rows 3 and 5 drive sent_overflow and pool-capacity overflow
    (48, 3, 16, 0, 8, 2.0, None),
    (48, 3, 16, 5, 8, 2.0, 16),
    (96, 5, 64, 8, 16, 0.8, 4),
    (24, 2, 16, 2, 32, 4.0, 4),
    (96, 5, 8, 0, 16, 0.5, None),
]


@pytest.mark.parametrize("n,d,k_max,k0,pb,lam,cap", SWEEP)
def test_gram_scan_matches_refit_reference(n, d, k_max, k0, pb, lam, cap):
    """Every discrete output bitwise against the D-dimensional refit
    reference; features to float reassociation."""
    rng = np.random.default_rng(n + k0)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 2.0)
    _, pool = _pools(k_max, d, min(k0, k_max), rng)
    txn = BPMeansTransaction(lam, k_max, init_mean=False)
    z0 = txn.make_state(x)
    fast = OCCEngine(txn, pb, validate_cap=cap, device="cpu").run(
        x, pool=pool, state=z0)
    rp, ra, rs, rst = reference_pass(txn, pool, x, state=z0, pb=pb, cap=cap)
    assert torch.equal(fast.assign, ra) and torch.equal(fast.send, rs)
    assert torch.equal(fast.stats.proposed, rst.proposed)
    assert torch.equal(fast.stats.accepted, rst.accepted)
    for f in ("mask", "count", "overflow"):
        assert torch.equal(getattr(fast.pool, f), getattr(rp, f)), f
    scale = max(1.0, float(rp.centers.abs().max()))
    np.testing.assert_allclose(_np(fast.pool.centers), _np(rp.centers),
                               rtol=0, atol=1e-5 * scale)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    x, _, _ = bp_stick_breaking_data(64, seed=0)
    for call in (lambda: occ_bp_means(x, LAM, 16, k_max=16),
                 lambda: serial_bp_means(x[:8], LAM, k_max=16),
                 lambda: serial_bp_means_pass(x[:8], LAM, 16),
                 lambda: OCCEngine(BPMeansTransaction(LAM, 16), 16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
