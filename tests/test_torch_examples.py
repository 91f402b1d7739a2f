"""The port's examples (`repro_torch.examples`) on the CPU against the JAX
package's (`examples/*.py`, run in this process with their output
captured).

Each port example returns the numbers it prints; its integers (K, counts,
labels, versions, bit-identity flags) must equal the ones the JAX example
prints for the same calls.  The multi-process acts (`--ha`) are left to
the cluster tests and to the card (`chip_smoke.py --phases examples`);
`retrieval_index` trains a 110k-center index, so here its sweep runs over
a small index published into both packages' stores.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import DPMeansTransaction as JTxn  # noqa: E402
from repro.core import OCCEngine as JEngine  # noqa: E402
from repro.serving import SnapshotStore as JStore  # noqa: E402

from repro_torch.convert import pool_from_numpy  # noqa: E402
from repro_torch.core import DPMeansTransaction, OCCEngine  # noqa: E402
from repro_torch.obs import load_trace, validate_trace  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    crash_recovery, observability, quickstart, retrieval_index, serve_lm,
    streaming_clusters,
)
from repro_torch.serving import SnapshotStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_JAX = {}


def _jax_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_out(name: str) -> str:
    """stdout of `examples/<name>.py`'s main() (once a module)."""
    if name not in _JAX:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _jax_module(name).main()
        _JAX[name] = buf.getvalue()
    return _JAX[name]


def _port(mod, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(["--device", "cpu", *argv])
    return out, buf.getvalue()


def _ints(pattern: str, text: str) -> tuple[int, ...]:
    m = re.search(pattern, text)
    assert m is not None, f"{pattern!r} not in {text!r}"
    return tuple(int(g) for g in m.groups())


def test_quickstart_equals_jax():
    got, text = _port(quickstart)
    out = _jax_out("quickstart")
    assert _ints(r"OCC DP-means:  K=(\d+) \(true (\d+)\), J=[\d.]+, "
                 r"proposed=(\d+), rejected=(\d+) \(bound Pb=256\), "
                 r"dispatches=(\d+)", out) == (
        got["K"], got["K_true"], got["proposed"], got["rejected"],
        got["dispatches"])
    assert _ints(r"serial DP-means: K=(\d+)", out) == (got["K_serial"],)
    assert _ints(r"OCC OFL:       K=(\d+)", out) == (got["K_ofl"],)
    assert _ints(r"OCC BP-means:  K=(\d+) features", out) == (got["K_bp"],)
    assert _ints(r"serving:       v(\d+) answered 100 queries in bucket "
                 r"(\d+), K=(\d+), topk\[0\]=\[(\d+), (\d+), (\d+)\]",
                 out) == (got["version"], got["bucket"], got["K_served"],
                          *got["topk0"])
    assert f"analytics scan degraded={got['degraded']}" in out
    # the port prints the same lines as the JAX example up to its pointers
    assert text.splitlines()[:5] == out.splitlines()[:5]


def test_streaming_clusters_equals_jax():
    got, text = _port(streaming_clusters)
    out = _jax_out("streaming_clusters")
    rows = [tuple(int(v) for v in m) for m in re.findall(
        r"batch \d+: len= *(\d+)  n_seen= *(\d+)  carried= *(\d+)  "
        r"K= *(\d+)  sent= *(\d+)", out)]
    assert rows == [(r["len"], r["n_seen"], r["carried"], r["K"], r["sent"])
                    for r in got["dp_batches"]]
    assert len(rows) == 6
    assert _ints(r"OFL stream:      K=(\d+)", out) == (got["K_ofl"],)
    assert "(ANY batching): True" in out and got["ofl_stream_eq_oneshot"]
    assert text.splitlines()[:9] == out.splitlines()[:9]


def test_crash_recovery_equals_jax():
    got, _ = _port(crash_recovery)
    out = _jax_out("crash_recovery")
    assert _ints(r"reference \(uninterrupted\): K=(\d+)", out) == (
        got["K_ref"],)
    assert _ints(r"WAL dir keeps (\d+) delta records \+ (\d+) checkpoints",
                 out) == (got["n_appended"], got["n_checkpoints"])
    assert _ints(r"recovered: checkpoint@v(\d+) \+ (\d+) deltas replayed -> "
                 r"version (\d+), watermark n_seen=(\d+)", out) == (
        got["ckpt_version"], got["n_replayed"], got["version"],
        got["n_seen"])
    assert _ints(r"resumed:   K=(\d+)", out) == (got["K_resumed"],)
    assert got["identical"] and "uninterrupted run: True" in out


def _near_zero_clock(real):
    """`real` moved to start at 0.  The JAX engine lays its synthesized
    epoch spans at `ts0 + e * step`; on a monotonic clock of some hours
    (1e10 us) that misses the next boundary by more than its validator's
    1e-6 us, so the JAX example's own trace check then fails by the
    machine's uptime alone."""
    base = real()
    return lambda: real() - base


def test_observability_equals_jax(tmp_path, monkeypatch):
    got, _ = _port(observability, "--out-dir", str(tmp_path))
    import repro.core.engine as jengine
    monkeypatch.setattr(jengine, "_obs_now",
                        _near_zero_clock(jengine._obs_now))
    out = _jax_out("observability")
    for name in ("engine_accepted", "engine_proposed", "wal_appends",
                 "wal_checkpoints", "engine_passes"):
        key = "engine_passes" if name == "engine_passes" else name
        assert _ints(rf"  {name} (\d+)\n", out) == (got[key],)
    assert _ints(r"engine passes: (\d+), .*\(K=(\d+), ", out) == (
        got["engine_passes"], got["K"])
    cats = re.search(r"categories (\[.*\])", out)[1]
    assert cats == str(got["trace_categories"])
    assert (tmp_path / "trace.json").exists() and "ha" not in got


@pytest.mark.parametrize("uptime_s", [0.0, 3.6e4, 1e7])
def test_observability_trace_nests_at_any_clock(tmp_path, monkeypatch,
                                                uptime_s):
    """The port's synthesized epoch spans nest in their pass, and tile it,
    whatever the monotonic clock reads (the machine's uptime)."""
    import repro_torch.core.engine as tengine
    real = _near_zero_clock(tengine._obs_now)
    monkeypatch.setattr(tengine, "_obs_now", lambda: uptime_s + real())
    got, text = _port(observability, "--out-dir", str(tmp_path))
    trace = load_trace(str(tmp_path / "trace.json"))
    assert validate_trace(trace) == []
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"
          and e["name"] in ("engine.pass", "engine.epoch")]
    passes = [e for e in ev if e["name"] == "engine.pass"]
    assert len(passes) == got["engine_passes"] > 0
    for p in passes:
        epochs = sorted((e for e in ev if e["name"] == "engine.epoch"
                         and p["ts"] <= e["ts"] <= p["ts"] + p["dur"]),
                        key=lambda e: e["ts"])
        assert len(epochs) == p["args"]["epochs"] > 0
        assert epochs[0]["ts"] == p["ts"]
        for a, b in zip(epochs, epochs[1:]):
            assert a["ts"] + a["dur"] == b["ts"]
        assert epochs[-1]["ts"] + epochs[-1]["dur"] == p["ts"] + p["dur"]


def test_serve_lm_equals_jax_counts():
    """Random weights differ between the packages (a torch generator here,
    jax.random there); the served counts agree, and tokens stay in the
    vocabulary.  Token parity on shared weights is tests/test_torch_lm.py's."""
    got, text = _port(serve_lm)
    out = _jax_out("serve_lm")
    assert _ints(r"served (\d+) requests, (\d+) new tokens", out) == (
        got["requests"], got["new_tokens"]) == (6, 48)
    assert all(len(o) == 8 and all(0 <= t < 128 for t in o)
               for o in got["outputs"].values())
    assert _ints(r"served (\d+) requests, (\d+) new tokens", text) == (6, 48)


def test_retrieval_chunks_bitwise():
    ref = _jax_module("retrieval_index")
    for n, seed in ((100, 0), (1000, 3)):
        assert np.array_equal(
            retrieval_index._chunk_embeddings(n, retrieval_index.DIM, seed),
            ref._chunk_embeddings(n, ref.DIM, seed))
    assert (retrieval_index.N_CHUNKS, retrieval_index.LAM,
            retrieval_index.K_MAX, retrieval_index.BUCKET,
            retrieval_index.TOPK) == (ref.N_CHUNKS, ref.LAM, ref.K_MAX,
                                      ref.BUCKET, ref.TOPK)


def test_retrieval_sweep_equals_jax():
    """The probe sweep over one index published into both packages' hier
    stores: every integer of each row (shards probed and skipped) and the
    recall equal; p = all bitwise flat in both.  The index is published
    from one JAX pass into both stores."""
    ref = _jax_module("retrieval_index")
    x = ref._chunk_embeddings(3000, ref.DIM, seed=0)
    jstore = JStore(hier=True)
    eng = JEngine(JTxn(ref.LAM, k_max=4096), pb=256)
    res = eng.run(jnp.asarray(x))
    jstore.publish_pass(res)
    tstore = SnapshotStore(hier=True, device="cpu")
    p = res.pool
    tstore.publish_pool(pool_from_numpy(
        np.asarray(p.centers), np.asarray(p.mask), np.asarray(p.count),
        np.asarray(p.overflow), device="cpu"))
    with contextlib.redirect_stdout(io.StringIO()):
        want = ref._serve_sweep(x, jstore, 128, (1, 4, "all"))
        got = retrieval_index._serve_sweep(x, tstore, 128, (1, 4, "all"))
    assert got.keys() == want.keys()
    for key in want:
        for field in ("p", "shards_probed", f"recall@{ref.TOPK}"):
            assert got[key][field] == want[key][field], (key, field)
        # p = all is the flat step, whose skipped tiles the port counts in
        # its kernels' tile width (serving/cluster_service.py)
        if key != "p_all":
            assert got[key]["tiles_skipped"] == want[key]["tiles_skipped"]
    assert got["p_all"]["exact_vs_flat"] and want["p_all"]["exact_vs_flat"]


def test_retrieval_main_serves_a_given_index():
    """`main(index=...)` serves an index trained elsewhere (here a small
    one, trained as `build_index` trains: a stream and its flush)."""
    x = retrieval_index._chunk_embeddings(2000, retrieval_index.DIM, seed=0)
    store = SnapshotStore(hier=True, device="cpu")
    eng = OCCEngine(DPMeansTransaction(retrieval_index.LAM, k_max=4096),
                    pb=256, validate_cap="adaptive",
                    publish=store.publish_pass, device="cpu")
    eng.partial_fit(x)
    eng.flush()
    assert int(eng.pool.count) >= 1000 and store.versions() == [1, 2]
    rec = retrieval_index.main(["--quick", "--device", "cpu", "--quiet"],
                               index=(x, store, 0.0, eng))
    assert rec["device"] == "cpu" and rec["n_queries"] == 256
    assert set(rec["sweep"]) == {"p4", "p_all"}
    assert rec["sweep"]["p_all"]["exact_vs_flat"]
    assert rec["k_centers"] == int(eng.pool.count)
    with pytest.raises(AssertionError, match="index too small"):
        retrieval_index.build_index(n_chunks=50, quiet=True, device="cpu")
