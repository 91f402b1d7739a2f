"""The port's host-driven pass, engine telemetry and multi-process cluster,
on the CPU (`device="cpu"`), against the port's fused pass and against the
JAX package on the same numpy inputs.

Fast tests pin the equivalence behind `launch/occ_cluster.py`:
`OCCEngine.run_from_proposals` (the master's epoch loop) is bit-identical
to the port's `run()` — with the local proposer, a bootstrap prefix, a
2-shard in-process proposer (the worker plane's reassembly in miniature)
and BP-means's tree-shaped outputs — and its labels, sends, stats and
(DP-means) centers equal the JAX package's `run_from_proposals`.  The
telemetry a pass exports equals the JAX engine's, timings aside.  Slow
tests spawn real worker, follower and HA node processes over loopback
and run the reference's audits.

Bar between the packages: integer outputs identical; DP-means centers
bitwise (they are data points); BP-means centers within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.obs import Obs as JObs, Tracer as JTracer  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BPMeansTransaction, DPMeansTransaction, OCCEngine,
)
from repro_torch.core.occ import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels.ref import assign_ref  # noqa: E402
from repro_torch.launch.occ_cluster import (  # noqa: E402
    ClusterConfig, run_cluster,
)
from repro_torch.obs import Obs, Tracer  # noqa: E402
from repro_torch.serving.snapshot import SnapshotStore  # noqa: E402

LAM = 4.0


def _eng(txn, pb, **kw):
    return OCCEngine(txn, pb=pb, device="cpu", **kw)


def _assert_bitwise(res, ref):
    """Full-pass bit-identity: pool, per-point outputs, and stats."""
    assert all(torch.equal(a, b) for a, b in zip(ref.pool, res.pool))
    for a, b in zip(tree_leaves(ref.assign), tree_leaves(res.assign)):
        assert torch.equal(a, b)
    for f in ("send", "epoch_of"):
        assert torch.equal(getattr(ref, f), getattr(res, f)), f
    for a, b in zip(ref.stats, res.stats):
        assert torch.equal(a, b)


# ------------------------------------------------- host-driven pass parity

def test_run_from_proposals_matches_fused_run():
    """Ragged final epoch (488 % 61 != 0): padding and valid-masking match
    the fused pass exactly, and the host loop counts one dispatch an
    epoch where run() counts one a pass."""
    x = tsyn.dp_stick_breaking_data(488, seed=11, dim=12)[0]
    txn = DPMeansTransaction(LAM, k_max=99)
    eng = _eng(txn, 61)
    res = eng.run_from_proposals(x)
    assert eng.n_dispatches == -(-488 // 61)
    ref_eng = _eng(txn, 61)
    _assert_bitwise(res, ref_eng.run(x))
    assert ref_eng.n_dispatches == 1


@pytest.mark.parametrize("nb", [1, 5, 40])
def test_run_from_proposals_with_bootstrap_prefix(nb):
    x = tsyn.dp_stick_breaking_data(256, seed=8)[0]
    txn = DPMeansTransaction(LAM, k_max=64)
    res = _eng(txn, 32).run_from_proposals(x, n_bootstrap=nb)
    _assert_bitwise(res, _eng(txn, 32).run(x, n_bootstrap=nb))


@pytest.mark.parametrize("cap,scan_mode", [(None, "serial"), (16, "serial"),
                                           (None, "logdepth")])
def test_two_shard_proposer_matches_fused_run(cap, scan_mode):
    """The cluster reassembly in miniature: each epoch's proposal block is
    two shard-width proposes, concatenated leaf by leaf in worker order."""
    x = tsyn.dp_stick_breaking_data(512, seed=5)[0]
    txn = DPMeansTransaction(LAM, k_max=128)
    spb = 32

    def sharded(pool, x_e, state_e, valid_e, *, epoch, offset):
        parts = []
        for w in range(2):
            cut = slice(w * spb, (w + 1) * spb)
            parts.append(txn.propose(pool, x_e[cut],
                                     tree_map(lambda s: s[cut], state_e)))
        send, payload, aux, safe = tree_map(
            lambda *p: torch.cat(p, 0), parts[0], parts[1])
        return send, payload, aux, safe, valid_e

    kw = dict(validate_cap=cap, scan_mode=scan_mode)
    res = _eng(txn, 64, **kw).run_from_proposals(x, sharded)
    _assert_bitwise(res, _eng(txn, 64, **kw).run(x))


@pytest.mark.parametrize("pb,workers,k_max,dim", [
    (64, 2, 128, 8), (128, 2, 256, 16), (512, 4, 512, 16),
    (2048, 4, 512, 16)])
def test_plain_propose_rows_independent_of_shard_width(pb, workers, k_max,
                                                       dim):
    """What the CPU cluster's audit rests on: the plain nearest-center
    version gives each shard's rows the bits of the full epoch's product
    (d² and argmin), at the cluster shapes including the card's
    (2048, 4 workers, 512, 16)."""
    rng = np.random.default_rng(pb + workers)
    x = torch.from_numpy(rng.normal(size=(pb, dim)).astype(np.float32) * 3)
    c = torch.from_numpy(rng.normal(size=(k_max, dim)).astype(np.float32) * 3)
    mask = torch.arange(k_max) < k_max // 2
    full = assign_ref(x, c, mask)
    spb = pb // workers
    for w in range(workers):
        cut = slice(w * spb, (w + 1) * spb)
        part = assign_ref(x[cut], c, mask)
        for a, b in zip(full, part):
            assert torch.equal(a[cut], b)


def test_bp_means_host_driven_matches_fused():
    """BP-means's (N, K) boolean assignment tree and its `None` aux leaf
    through the host loop."""
    xb = tsyn.bp_stick_breaking_data(128, seed=2)[0]
    txn = BPMeansTransaction(LAM, k_max=32)
    res = _eng(txn, 32).run_from_proposals(xb)
    _assert_bitwise(res, _eng(txn, 32).run(xb))


def test_run_from_proposals_refuses_adaptive_and_mesh():
    x = tsyn.dp_stick_breaking_data(64, seed=0)[0]
    txn = DPMeansTransaction(LAM, k_max=32)
    with pytest.raises(ValueError, match="adaptive"):
        _eng(txn, 32, validate_cap="adaptive").run_from_proposals(x)
    eng = _eng(txn, 32)
    eng.mesh = object()      # any mesh: the host loop cannot shard it
    with pytest.raises(ValueError, match="mesh"):
        eng.run_from_proposals(x)


def test_on_commit_publishes_every_epoch():
    """The per-epoch replication hook fires after each commit with the
    committed pool; on_outputs fires before it with the epoch's raw block."""
    x = tsyn.dp_stick_breaking_data(256, seed=4)[0]
    txn = DPMeansTransaction(LAM, k_max=64)
    store = SnapshotStore(capacity=16, delta=True, model="m", device="cpu")
    seen, order = [], []

    def on_outputs(epoch, assign_e, send_e, stats):
        order.append(("out", epoch))
        assert assign_e.shape == send_e.shape == (32,)

    def on_commit(pool, epoch, t_epochs):
        order.append(("commit", epoch))
        seen.append((epoch, t_epochs, int(pool.count)))
        store.publish_pool(pool, epochs=epoch + 1)

    res = _eng(txn, 32).run_from_proposals(x, on_commit=on_commit,
                                           on_outputs=on_outputs)
    assert [e for e, _, _ in seen] == list(range(8))
    assert all(t == 8 for _, t, _ in seen)
    assert order == [(k, e) for e in range(8) for k in ("out", "commit")]
    counts = [c for _, _, c in seen]
    assert counts == sorted(counts)          # validator only appends
    assert counts[-1] == int(res.pool.count)
    assert store.versions() == list(range(1, 9))
    assert torch.equal(store.latest().centers[:counts[-1]],
                       res.pool.centers[:counts[-1]])


def test_epoch_base_shifts_reported_epochs_only():
    """A resumed pass (`epoch_base`, a seeded pool) reports global epochs
    and equals the tail of the uninterrupted pass."""
    x = tsyn.dp_stick_breaking_data(256, seed=3)[0]
    txn = DPMeansTransaction(LAM, k_max=64)
    head = []
    full = _eng(txn, 32).run_from_proposals(
        x, on_commit=lambda p, e, t: head.append(
            tree_map(torch.clone, p)) if e == 2 else None)
    seen = []
    tail = _eng(txn, 32).run_from_proposals(
        x[96:], pool=head[0], epoch_base=3,
        on_commit=lambda p, e, t: seen.append(e))
    assert seen == list(range(3, 8))
    assert all(torch.equal(a, b) for a, b in zip(full.pool, tail.pool))
    assert torch.equal(full.assign[96:], tail.assign)


# ------------------------------------------------------- against the JAX package

def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("n,pb,k_max,nb,seed", [
    (488, 61, 99, 0, 11), (1024, 64, 128, 0, 0), (1024, 128, 128, 8, 1),
    (2048, 128, 256, 0, 2)])
def test_run_from_proposals_matches_jax(n, pb, k_max, nb, seed):
    """Labels, sends, epochs and OCCStats identical to the JAX package's
    host-driven pass; centers bitwise (DP-means centers are data points)."""
    x = tsyn.dp_stick_breaking_data(n, seed=seed)[0]
    np.testing.assert_array_equal(x, jsyn.dp_stick_breaking_data(n,
                                                                  seed=seed)[0])
    jr = jcore.OCCEngine(jcore.DPMeansTransaction(LAM, k_max), pb) \
        .run_from_proposals(jnp.asarray(x), n_bootstrap=nb)
    tr = _eng(DPMeansTransaction(LAM, k_max), pb).run_from_proposals(
        x, n_bootstrap=nb)
    for f in ("assign", "send", "epoch_of"):
        np.testing.assert_array_equal(_np(getattr(jr, f)),
                                      _np(getattr(tr, f)), err_msg=f)
    for f in ("proposed", "accepted", "cap"):
        np.testing.assert_array_equal(_np(getattr(jr.stats, f)),
                                      _np(getattr(tr.stats, f)), err_msg=f)
    for f in ("centers", "mask", "count", "overflow"):
        np.testing.assert_array_equal(_np(getattr(jr.pool, f)),
                                      _np(getattr(tr.pool, f)), err_msg=f)


def test_bp_means_run_from_proposals_matches_jax():
    xb = tsyn.bp_stick_breaking_data(128, seed=2)[0]
    jr = jcore.OCCEngine(jcore.BPMeansTransaction(LAM, 32), 32) \
        .run_from_proposals(jnp.asarray(xb))
    tr = _eng(BPMeansTransaction(LAM, 32), 32).run_from_proposals(xb)
    np.testing.assert_array_equal(_np(jr.assign), _np(tr.assign))
    np.testing.assert_array_equal(_np(jr.send), _np(tr.send))
    for f in ("proposed", "accepted", "cap"):
        np.testing.assert_array_equal(_np(getattr(jr.stats, f)),
                                      _np(getattr(tr.stats, f)), err_msg=f)
    np.testing.assert_allclose(_np(jr.pool.centers), _np(tr.pool.centers),
                               rtol=1e-5, atol=1e-5)


def test_proposal_leaves_follow_jax_flatten_order():
    """A PROPOSE frame's leaves: the port's `tree_leaves` of a proposal
    has JAX's tree-flatten order, shapes and dtypes, and its integer and
    boolean leaves and payload are equal."""
    x = tsyn.dp_stick_breaking_data(256, seed=6)[0]
    jtxn = jcore.DPMeansTransaction(LAM, 64)
    ttxn = DPMeansTransaction(LAM, 64)
    jx = jnp.asarray(x)
    jpool = jcore.OCCEngine(jtxn, 64).run(jx[:128]).pool
    tpool = _eng(ttxn, 64).run(x[:128]).pool
    jl = jax.tree_util.tree_leaves(jtxn.propose(jpool, jx[128:192], ()))
    tl = tree_leaves(ttxn.propose(tpool, torch.from_numpy(x[128:192]), ()))
    assert len(jl) == len(tl) == 5
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype != np.float32 or a.ndim == 2:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- telemetry

def _telemetry(obs):
    """Counters and gauges by name, span names and their args with the
    timing fields dropped."""
    dump = obs.metrics.dump()
    values = {name: fam["values"] for name, fam in dump.items()
              if fam["type"] in ("counter", "gauge")}
    hists = {name: {k: v["count"] for k, v in fam["values"].items()}
             for name, fam in dump.items() if fam["type"] == "histogram"}
    spans = [(ev["name"], ev.get("args")) for ev in obs.tracer.events()
             if ev.get("ph") == "X"]
    return values, hists, spans


@pytest.mark.parametrize("driver", ["run", "run_from_proposals"])
def test_telemetry_equals_jax_engine(driver):
    """After one pass, counters, gauges, histogram counts, span names and
    span args equal the JAX engine's (timings aside)."""
    x = tsyn.dp_stick_breaking_data(512, seed=7)[0]
    jobs = JObs(tracer=JTracer("t"))
    tobs = Obs(tracer=Tracer("t"))
    je = jcore.OCCEngine(jcore.DPMeansTransaction(LAM, 128), 64, obs=jobs)
    te = _eng(DPMeansTransaction(LAM, 128), 64, obs=tobs)
    getattr(je, driver)(jnp.asarray(x))
    getattr(te, driver)(x)
    jv, jh, js = _telemetry(jobs)
    tv, th, ts = _telemetry(tobs)
    assert tv == jv and th == jh and ts == js
    names = {s[0] for s in ts}
    assert names == ({"engine.pass", "engine.epoch"} if driver == "run" else
                     {"engine.propose", "engine.validate", "engine.epoch"})


def test_telemetry_off_and_on_give_equal_passes():
    """obs= changes nothing the pass computes."""
    x = tsyn.dp_stick_breaking_data(512, seed=9)[0]
    txn = DPMeansTransaction(LAM, 128)
    a = _eng(txn, 64).run(x)
    b = _eng(txn, 64, obs=Obs(tracer=Tracer("t"))).run(x)
    _assert_bitwise(b, a)


# ------------------------------------------------- real processes (slow)

QUICK = dict(n=1024, dim=8, pb=64, k_max=128, lam=3.0,
             n_workers=2, n_followers=1, quiet=True, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cluster_entry_points_refuse_cuda_without_a_card():
    from repro_torch.launch.ha_cluster import HAConfig, run_ha_cluster
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cluster(ClusterConfig(**{**QUICK, "device": "cuda"}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ha_cluster(HAConfig(n=1024, device="cuda", quiet=True))


@pytest.mark.slow
def test_multiproc_e2e_bit_identical(tmp_path):
    """2 worker processes + follower processes over loopback: the full
    audit — bit-identity to the single-process pass, follower digests,
    late-joiner bootstrap, full version streams, workers' reports."""
    out = tmp_path / "transport.json"
    rec = run_cluster(ClusterConfig(**QUICK, out_path=str(out),
                                    trace_out=str(tmp_path / "tr.json")))
    assert all(rec["bit_identical"].values())
    assert rec["follower_digests_match"] and all(rec["follower_digests_match"])
    assert rec["late_joiners_bootstrapped"]
    assert rec["full_stream_versions_match"]
    assert rec["worker_deaths"] == {}
    assert rec["worker_exitcodes"] == [0, 0]
    assert [r["epochs"] for r in rec["worker_reports"]] == [16, 16]
    assert rec["followers"] == 2             # initial + late joiner
    assert rec["epochs"] == 16 and rec["versions_published"] == 16
    assert rec["n_acks"] > 0 and rec["ack_p99_ms"] >= rec["ack_p50_ms"]
    assert rec["delta_bytes_per_publish"] > 0
    assert set(rec["master_span_s"]) == {"engine.propose", "engine.validate"}
    assert out.exists() and (tmp_path / "tr.json").exists()


@pytest.mark.slow
def test_multiproc_worker_death_is_deterministic():
    """Worker 1 exits hard on STEP for epoch 3: the master masks that
    shard from exactly epoch 3 on and lands bit-identical to the
    in-process reference with the same masks."""
    rec = run_cluster(ClusterConfig(**QUICK, die_worker=1, die_epoch=3))
    assert rec["worker_deaths"] == {1: 3}
    assert rec["worker_exitcodes"] == [0, 3]
    assert all(rec["bit_identical"].values())
    assert rec["follower_digests_match"] and all(rec["follower_digests_match"])


@pytest.mark.slow
def test_multiproc_follower_kill_replacement_bootstraps():
    """SIGKILL the only follower mid-publish: the primary keeps publishing
    and the replacement resyncs via a SNAPSHOT bootstrap to the same
    bit-identical store."""
    rec = run_cluster(ClusterConfig(**QUICK, late_follower=False,
                                    kill_follower_at_epoch=4))
    assert rec["followers"] == 1             # the killed one wrote no report
    assert rec["n_bootstraps"] >= 1
    assert all(rec["bit_identical"].values())
    assert rec["follower_digests_match"] and all(rec["follower_digests_match"])
    assert rec["late_joiners_bootstrapped"]


@pytest.mark.slow
def test_ha_kill_master_promotes_resumes_bit_identical(tmp_path):
    """SIGKILL the master right after version 6 is fully replicated: the
    follower with the highest watermark is promoted with a fenced term,
    workers reconnect, the pass resumes from epoch 6 — every epoch
    digest, stats triple, the final store, every surviving follower and
    the promoted master's WAL equal an uninterrupted single-process run."""
    from repro_torch.launch.ha_cluster import HAConfig, run_ha_cluster
    rec = run_ha_cluster(HAConfig(n=1024, dim=8, pb=64, k_max=128, lam=3.0,
                                  n_workers=2, n_nodes=3,
                                  kill_master_after_version=6, quiet=True,
                                  wal_dir=str(tmp_path / "wal"),
                                  device="cpu"))
    assert rec["promotions"] == 1 and rec["terms"] == [1, 2]
    assert rec["resume_epoch"] == 6          # == the acked kill version
    assert rec["master_node_final"] == 1     # watermark tie → lowest node id
    assert rec["epoch_digests_match"] and rec["epoch_stats_match"]
    assert rec["final_digest_match"]
    assert rec["follower_digests_match"] and all(rec["follower_digests_match"])
    assert rec["recomputed_overlap_epochs"] == []   # no epoch ran twice
    assert rec["wal_digest_match"] is True and rec["exit_codes_ok"]
