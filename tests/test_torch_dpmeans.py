"""The slice end to end: OCC DP-means in the port against the JAX package,
and the port's own bitwise invariants, on the CPU (`device="cpu"`).

Bar between the packages: labels, sends, epochs, K and OCCStats identical;
f32 centers and objectives within rtol = atol = 1e-5 (XLA and torch sum in
different orders).  Inside the port every invariant is bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DPMeansTransaction, OCCEngine, occ_dp_means, serial_dp_means,
    serial_dp_means_pass, thm31_permutation,
)
from repro_torch.core._reference import reference_pass  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
N, PB, K_MAX, LAM = 1024, 128, 128, 4.0


def _data(kind):
    if kind == "separable":
        return tsyn.separable_cluster_data(N, seed=1)[0], 1.0
    return tsyn.dp_stick_breaking_data(N, seed=0)[0], LAM


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_results_match(jr, tr, centers_exact=False):
    for f in ("assign", "send", "epoch_of"):
        np.testing.assert_array_equal(_np(getattr(jr, f)),
                                      _np(getattr(tr, f)), err_msg=f)
    for f in ("proposed", "accepted", "cap"):
        np.testing.assert_array_equal(_np(getattr(jr.stats, f)),
                                      _np(getattr(tr.stats, f)), err_msg=f)
    for f in ("mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jr.pool, f)),
                                      _np(getattr(tr.pool, f)), err_msg=f)
    if centers_exact:
        np.testing.assert_array_equal(_np(jr.pool.centers), _np(tr.pool.centers))
    else:
        np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers),
                                   **TOL)


def _bitwise(a, b):
    return all(torch.equal(u, v) for u, v in
               ((a.assign, b.assign), (a.send, b.send),
                (a.epoch_of, b.epoch_of), (a.stats.proposed, b.stats.proposed),
                (a.stats.accepted, b.stats.accepted), *zip(a.pool, b.pool)))


@pytest.mark.parametrize("kind,cap,scan_mode,nb", [
    ("dp", None, "serial", 0),
    ("dp", 32, "serial", 0),
    ("dp", "adaptive", "serial", 0),
    ("dp", None, "logdepth", 0),
    ("dp", "adaptive", "logdepth", 8),
    ("separable", None, "serial", 8),
    ("separable", 16, "logdepth", 0),
])
def test_engine_two_passes_match_jax(kind, cap, scan_mode, nb):
    """Pass, refine, second pass from the refined pool (the adaptive cap
    shrinks there), in both packages on the same data."""
    x, lam = _data(kind)
    je = jcore.OCCEngine(jcore.DPMeansTransaction(lam, K_MAX), PB,
                         validate_cap=cap, scan_mode=scan_mode)
    te = OCCEngine(DPMeansTransaction(lam, K_MAX), PB, validate_cap=cap,
                   scan_mode=scan_mode, device="cpu")
    jx = jnp.asarray(x)
    jr = je.run(jx, n_bootstrap=nb)
    tr = te.run(x, n_bootstrap=nb)
    _assert_results_match(jr, tr, centers_exact=True)
    jpool = je.refine(jr.pool, jx, jr.assign)
    tpool = te.refine(tr.pool, x, tr.assign)
    np.testing.assert_allclose(_np(jpool.centers), _np(tpool.centers), **TOL)
    assert tpool.centers.is_contiguous()
    # the second pass starts from the JAX pool carried across, so both
    # packages see the same bits
    tpool = convert.pool_from_numpy(*(np.asarray(a) for a in jpool),
                                    device="cpu")
    _assert_results_match(je.run(jx, pool=jpool), te.run(x, pool=tpool),
                          centers_exact=True)
    assert je.cap_history == te.cap_history
    assert je.n_dispatches == te.n_dispatches


def test_occ_dp_means_wrapper_matches_jax():
    x, _ = _data("dp")
    jr = jcore.occ_dp_means(jnp.asarray(x), LAM, PB, k_max=K_MAX, max_iters=3,
                            bootstrap=True)
    tr = occ_dp_means(x, LAM, PB, k_max=K_MAX, max_iters=3, bootstrap=True,
                      device="cpu")
    for f in ("z", "send", "epoch_of"):
        np.testing.assert_array_equal(_np(getattr(jr, f)), _np(getattr(tr, f)))
    np.testing.assert_array_equal(_np(jr.stats.proposed), _np(tr.stats.proposed))
    np.testing.assert_array_equal(_np(jr.stats.accepted), _np(tr.stats.accepted))
    assert jr.n_iters == tr.n_iters
    np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers), **TOL)
    np.testing.assert_allclose(float(jr.objective), float(tr.objective), **TOL)


def test_serial_dp_means_matches_jax():
    x, _ = _data("dp")
    x = x[:384]
    jr = jcore.serial_dp_means(jnp.asarray(x), LAM, k_max=K_MAX, max_iters=3)
    tr = serial_dp_means(x, LAM, k_max=K_MAX, max_iters=3, device="cpu")
    np.testing.assert_array_equal(_np(jr.z), _np(tr.z))
    assert int(jr.pool.count) == int(tr.pool.count) and jr.n_iters == tr.n_iters
    np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers), **TOL)


# ------------------------------------------------- inside the port, bitwise

@pytest.mark.parametrize("pb", [64, 256])
def test_thm31_occ_equals_serial_along_permutation(pb):
    x, _ = _data("dp")
    res = OCCEngine(DPMeansTransaction(LAM, K_MAX), pb, device="cpu").run(x)
    perm = torch.from_numpy(thm31_permutation(res, N))
    pool, z = serial_dp_means_pass(torch.from_numpy(x)[perm], LAM, K_MAX,
                                   device="cpu")
    assert torch.equal(z, res.assign[perm])
    assert all(torch.equal(a, b) for a, b in zip(pool, res.pool))


def test_logdepth_and_adaptive_equal_serial_full_cap():
    x, _ = _data("dp")

    def two(**kw):
        eng = OCCEngine(DPMeansTransaction(LAM, K_MAX), PB, device="cpu", **kw)
        r1 = eng.run(x)
        r2 = eng.run(x, pool=eng.refine(r1.pool, x, r1.assign))
        return r1, r2, eng
    base = two()
    for kw in (dict(scan_mode="logdepth"), dict(validate_cap="adaptive"),
               dict(validate_cap="adaptive", scan_mode="logdepth")):
        other = two(**kw)
        assert _bitwise(base[0], other[0]) and _bitwise(base[1], other[1]), kw
    assert base[2].cap_history == [None, None]
    assert other[2].cap_history[-1] is not None      # the cap did shrink


def test_adaptive_forced_retry_is_lossless():
    """A quiet prefix shrinks the window; a burst then overflows it and the
    pass is re-run at full width: results equal the unbounded master."""
    rng = np.random.default_rng(11)
    quiet = rng.normal(size=(192, 4)).astype(np.float32) * 0.1
    burst = rng.normal(size=(64, 4)).astype(np.float32) * 50.0
    x = np.concatenate([quiet, burst])
    ea = OCCEngine(DPMeansTransaction(2.0, 256), 64, validate_cap="adaptive",
                   device="cpu")
    ef = OCCEngine(DPMeansTransaction(2.0, 256), 64, device="cpu")
    for lo in range(0, 256, 64):
        assert _bitwise(ea.partial_fit(x[lo:lo + 64]),
                        ef.partial_fit(x[lo:lo + 64]))
    assert ea.n_cap_retries >= 1
    assert ea.n_dispatches == ef.n_dispatches + ea.n_cap_retries


def test_ragged_stream_equals_one_shot():
    x = _data("dp")[0][:1000]          # ends in a short epoch
    n = x.shape[0]
    one = OCCEngine(DPMeansTransaction(LAM, K_MAX), PB, device="cpu").run(x)
    eng = OCCEngine(DPMeansTransaction(LAM, K_MAX), PB, device="cpu")
    parts = [eng.partial_fit(x[a:b]) for a, b in
             ((0, 5), (5, 300), (300, 301), (301, 777), (777, n))]
    assert parts[0].assign.shape == (0,) and parts[0].assign.dtype == torch.int32
    assert eng.n_pending == n % PB and eng.n_processed == n - n % PB
    parts.append(eng.flush())
    assert eng.flush() is None and eng.n_pending == 0
    for f in ("assign", "send", "epoch_of"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]),
                           getattr(one, f))
    assert all(torch.equal(a, b) for a, b in zip(eng.pool, one.pool))
    assert torch.equal(eng.stats.proposed, one.stats.proposed)
    assert torch.equal(eng.stats.accepted, one.stats.accepted)
    assert eng.epochs_done == one.stats.proposed.shape[0]
    eng.reset_stream()
    assert eng.pool is None and eng.n_seen == 0 and eng.stats.proposed.numel() == 0


@pytest.mark.parametrize("cap", [None, 24])
def test_fast_validator_equals_reference_pass(cap):
    x, _ = _data("separable")
    txn = DPMeansTransaction(1.0, K_MAX)
    eng = OCCEngine(txn, PB, validate_cap=cap, device="cpu")
    res = eng.run(x)
    xt = torch.from_numpy(x)
    pool, assign, send, stats = reference_pass(txn, txn.init_pool(xt), xt,
                                               pb=PB, cap=cap)
    assert torch.equal(assign, res.assign) and torch.equal(send, res.send)
    assert all(torch.equal(a, b) for a, b in zip(pool, res.pool))
    assert all(torch.equal(a, b) for a, b in zip(stats, res.stats))


def test_publish_hook_and_dispatch_count():
    x, _ = _data("dp")
    seen = []
    eng = OCCEngine(DPMeansTransaction(LAM, K_MAX), PB, device="cpu",
                    publish=lambda res, **kw: seen.append(kw))
    eng.partial_fit(x[:300])
    eng.flush()
    assert [s["n_seen"] for s in seen] == [256, 300]
    assert [s["epochs"] for s in seen] == [2, 3]
    assert eng.n_dispatches == 2 and eng.n_epochs_dispatched == 3


# ----------------------------------------------------- data, state, devices

def test_synthetic_data_is_a_bitwise_copy():
    for name, kw in (("dp_stick_breaking_data", dict(n=500, seed=3)),
                     ("bp_stick_breaking_data", dict(n=300, seed=4)),
                     ("separable_cluster_data", dict(n=400, dim=5, seed=5))):
        for a, b in zip(getattr(jsyn, name)(**kw), getattr(tsyn, name)(**kw)):
            np.testing.assert_array_equal(a, b)


def test_convert_round_trip():
    x, _ = _data("dp")
    res = OCCEngine(DPMeansTransaction(LAM, K_MAX), PB, device="cpu").run(x)
    arrs = convert.pool_to_numpy(res.pool)
    assert arrs["count"].dtype == np.int32 and arrs["mask"].dtype == np.bool_
    back = convert.pool_from_numpy(**arrs, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, res.pool))
    st = convert.stats_to_numpy(res.stats)
    np.testing.assert_array_equal(st["proposed"], res.stats.proposed.numpy())
    assert convert.stats_to_numpy(res.stats._replace(cap=None))["cap"] is None


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    x, _ = _data("dp")
    txn = DPMeansTransaction(LAM, K_MAX)
    for call in (lambda: OCCEngine(txn, PB),
                 lambda: occ_dp_means(x, LAM, PB),
                 lambda: serial_dp_means(x[:8], LAM),
                 lambda: serial_dp_means_pass(x[:8], LAM, K_MAX),
                 lambda: convert.pool_from_numpy(np.zeros((2, 2)), np.zeros(2),
                                                 0, False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(NotImplementedError):
        OCCEngine(txn, PB, obs=object(), device="cpu")
    with pytest.raises(ValueError):
        OCCEngine(txn, PB, validate_cap="huge", device="cpu")
