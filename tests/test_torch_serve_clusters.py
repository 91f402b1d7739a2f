"""The port's train-while-serve pipeline (`repro_torch.launch.serve_clusters`)
against the JAX package's, on the CPU at `--quick` sizes.

The port runs its multi-tenant run on `device="cpu"` (plain versions of the
kernels) with every audit of the reference inside it: zero stale reads by
replay, serve == train, delta == eager, stream == one-shot and coalesced
fill above solo.  Each tenant's final pool is then held against the JAX
engine's streaming the same batches: K, mask, published versions and
nearest-center labels identical, centers within the parity bar (1e-5).
The QoS arms run with their replay audits; what depends on timing (the
p99 order of the arms, how often shedding fires) is held on the card by
`chip_smoke.py --phases serve_clusters` only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import DPMeansTransaction as JTxn  # noqa: E402
from repro.core import OCCEngine as JEngine  # noqa: E402
from repro.core.occ import nearest_center as j_nearest  # noqa: E402
from repro.data import dp_stick_breaking_data  # noqa: E402
from repro.launch import serve_clusters as jsc  # noqa: E402

from repro_torch.core.occ import nearest_center  # noqa: E402
from repro_torch.launch import serve_clusters as tsc  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    return tsc.quick_config(device="cpu", quiet=True, **kw)


@pytest.fixture(scope="module")
def served():
    """One quick train-while-serve run on the CPU (the audits inside)."""
    cfg = _cfg()
    record, tenants, router = tsc._train_while_serve(cfg, Obs())
    router.close()
    return cfg, record, tenants


def _jax_tenant(cfg, i):
    """The JAX engine streaming tenant i's batches as the port's trainer
    does (first batch, the rest, flush); -> (engine, versions published)."""
    x, _, _ = dp_stick_breaking_data(cfg.n, seed=cfg.seed + 17 * i,
                                     dim=cfg.dim)
    x = jnp.asarray(x)
    published = []
    eng = JEngine(JTxn(cfg.lam * (1.0 + 0.25 * i), k_max=cfg.k_max),
                  pb=cfg.pb, validate_cap="adaptive",
                  publish=lambda res, **kw: published.append(kw["n_seen"]))
    for j in range(0, cfg.n, cfg.train_batch):
        eng.partial_fit(x[j:j + cfg.train_batch])
    eng.flush()
    return x, eng, published


def test_audits_hold_on_the_cpu(served):
    cfg, rec, tenants = served
    assert rec["device"] == "cpu"
    assert rec["zero_stale_reads"] and rec["serve_train_parity"]
    assert rec["delta_eq_eager"] and rec["stream_eq_oneshot"]
    assert rec["n_replayed"] > 0 and rec["n_queries"] >= cfg.min_queries
    assert min(rec["n_versions_observed"].values()) >= cfg.min_versions
    assert rec["bucket_fill_coalesced"] > rec["bucket_fill_solo"]
    assert set(rec["trainer_s"]) == {"a", "b"}


@pytest.mark.parametrize("i", [0, 1])
def test_tenant_pool_equals_jax_engine(served, i):
    cfg, rec, tenants = served
    tn = tenants[chr(ord("a") + i)]
    jx, jeng, published = _jax_tenant(cfg, i)
    jp, tp = jeng.pool, tn.engine.pool
    k = int(jp.count)
    assert int(tp.count) == k == rec["k_final"][tn.name]
    np.testing.assert_array_equal(tp.mask.numpy(), np.asarray(jp.mask))
    np.testing.assert_allclose(tp.centers.numpy(), np.asarray(jp.centers),
                               **TOL)
    # every committed pass published once, in both packages
    assert len(tn.store) == len(published) == rec["n_versions_published"][
        tn.name]
    assert [tn.store.get(v).n_seen for v in tn.store.versions()] == published
    # nearest-center labels of the whole stream under each final pool
    _, tl = nearest_center(tp, tn.x, backend="plain")
    _, jl = j_nearest(jp, jx, backend="ref")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_qos_schedule_equals_jax():
    cfg = _cfg()
    jcfg = jsc.ServeDemoConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(jsc.
                                                                ServeDemoConfig)})
    assert tsc._qos_schedule(cfg) == jsc._qos_schedule(jcfg)


def test_qos_arms_replay_every_response():
    """Both arms of the A/B with their audits: every non-degraded response
    replays bit-exactly from its tagged version, every degraded one from
    its stale pin, interactive traffic is never degraded, and the FIFO arm
    (one lane) never sheds."""
    cfg = _cfg(qos_interactive_requests=30, qos_analytics_requests=6)
    obs = Obs()
    sched = tsc._qos_schedule(cfg)
    arms = {lanes: tsc._qos_mode(cfg, obs, sched, priority_lanes=lanes)
            for lanes in (True, False)}
    for arm in arms.values():
        assert arm["n_interactive"] == 6 * 30 and arm["n_analytics"] == 2 * 6
        assert arm["n_replayed"] + arm["n_degraded_replayed"] == 6 * 30 + 12
        assert arm["n_shed"] == arm["n_degraded_replayed"]
        assert arm["versions_published"] >= 2
    assert arms[False]["n_shed"] == 0


def test_run_demo_signature_matches_jax():
    port = {f.name for f in dataclasses.fields(tsc.ServeDemoConfig)}
    ref = {f.name for f in dataclasses.fields(jsc.ServeDemoConfig)}
    assert port == ref | {"device"}
    assert tsc.ServeDemoConfig().device == "cuda"
    assert tsc.ServeDemoConfig().out_path is None


def test_kernel_build_and_bind_once_under_threads(tmp_path, monkeypatch):
    """Threads that reach a kernel library's first use together (a trainer,
    clients, an admission queue) build it once, load it once and bind each
    entry point once; the build's temporary file is the process's and the
    thread's own.  A fake nvcc records its calls."""
    import stat
    import sys
    import threading

    from repro_torch.kernels import _build
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv) + '\\n')\n"
        "time.sleep(0.3)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    loads = []

    class FakeLib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):      # a new object at every lookup
            return type("Fn", (), {})()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FUNCS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    got, errors = [], []
    start = threading.Barrier(8)

    def user():
        try:
            start.wait()
            got.append(_build.function("fake", "fake_fwd", [], None))
        except Exception as e:         # surfaced by the assert below
            errors.append(e)
    threads = [threading.Thread(target=user) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    calls = log.read_text().splitlines()
    assert len(calls) == 1 and len(loads) == 1
    assert len({id(fn) for fn in got}) == 1 and len(got) == 8
    tmp = calls[0].split(" -o ")[1].split()[0]
    assert tmp.endswith(".tmp") and tmp.count(".") >= 3   # pid and thread
    assert sorted(p.name for p in out.iterdir()) == [
        _build._library("fake")[1].name]
