"""OCC data curation in the port (`repro_torch.data.tokens`, `curation`,
`Model._embed` / `_body_train` and the `data_curation` example) against
the JAX package, on the CPU.

The token batches are numpy and bitwise equal.  The embeddings come from
reduced granite-3-2b in float32 with the JAX package's weights carried over
by `convert.lm_params_from_numpy`, and agree within 1e-4 x max(1, max |e|).
`curate` on the same numpy embeddings gives identical integers: K, the
labels, the weights and the duplicate fraction.  On the card,
`chip_smoke.py --phases curation` runs the full-width model.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import dp_stick_breaking_data  # noqa: E402
from repro.data.curation import curate as j_curate  # noqa: E402
from repro.data.curation import embed_sequences as j_embed  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.data.tokens import synthetic_token_batches as j_batches  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import TokenPipeline, synthetic_token_batches  # noqa: E402
from repro_torch.data.curation import curate, embed_sequences  # noqa: E402
from repro_torch.examples import data_curation  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


@pytest.mark.parametrize("host", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_token_batches_bitwise(host):
    idx, count = host
    jp = JPipe(97, global_batch=8, seq_len=12, seed=5, host_index=idx,
               host_count=count)
    tp = TokenPipeline(97, global_batch=8, seq_len=12, seed=5,
                       host_index=idx, host_count=count)
    assert tp.host_batch == jp.host_batch == 8 // count
    for step in (0, 1, 7, 1000):
        a, b = tp.batch_at(step), jp.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for a, b in zip(synthetic_token_batches(50, 4, 9, 3, seed=2),
                    j_batches(50, 4, 9, 3, seed=2)):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    first = next(iter(tp))
    assert np.array_equal(first["tokens"], jp.batch_at(0)["tokens"])


def _granite_pair():
    jcfg = jreduced(JARCHS["granite-3-2b"]).replace(dtype="float32")
    cfg = reduced(get_arch("granite-3-2b")).replace(dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    tm = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jm, params, tm


@pytest.fixture(scope="module")
def granite():
    return _granite_pair()


def _batches(vocab, n=3, seq=32):
    pipe = JPipe(vocab, global_batch=8, seq_len=seq, seed=0)
    return [pipe.batch_at(s) for s in range(n)]


def test_embed_and_body_equal_jax(granite):
    jm, params, tm = granite
    batches = _batches(tm.cfg.vocab)
    want = np.asarray(j_embed(jm, params, [
        {k: jnp.asarray(v) for k, v in b.items()} for b in batches]))
    got = embed_sequences(tm, batches)
    assert got.dtype == torch.float32 and got.shape == want.shape == (24, 64)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               rtol=0)
    # the hidden states behind them, and prefill through the same body
    x, n_prefix = tm._embed(batches[0])
    jx, jn = jm._embed(params, {"tokens": jnp.asarray(batches[0]["tokens"])})
    assert n_prefix == jn == 0
    np.testing.assert_array_equal(x.detach().numpy(), np.asarray(jx))
    with torch.inference_mode():
        h, caches = tm._body_train(x, tm._positions(x.shape[1]),
                                   want_cache=True)
    jh, jc = jm._body_train(params, jx, jnp.arange(x.shape[1],
                                                   dtype=jnp.float32),
                            want_cache=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh),
                               atol=ATOL * max(1.0, np.abs(jh).max()),
                               rtol=0)
    assert len(caches["seg_00"]) == tm.cfg.n_layers
    # an encoder output reaches only the encoder-decoder's decoder blocks:
    # granite's blocks ignore it, as the JAX package's do
    with torch.inference_mode():
        h2, _ = tm._body_train(x, tm._positions(x.shape[1]), enc_out=x)
    assert torch.equal(h2, h)


@pytest.mark.parametrize("pb,k_max", [(32, 64), (16, 16)])
def test_curate_equals_jax_on_same_embeddings(granite, pb, k_max):
    """(16, 16): the pool overflows, as the example's does."""
    jm, params, _ = granite
    batches = _batches(jm.cfg.vocab, n=4)
    e = np.array(j_embed(jm, params, [
        {k: jnp.asarray(v) for k, v in b.items()} for b in batches]))
    e[8:16] = e[0]                       # a batch of exact duplicates
    lam = 0.5 * float(np.median(np.linalg.norm(e - e.mean(0), axis=1)))
    jr = j_curate(jnp.asarray(e), lam=lam, pb=pb, k_max=k_max)
    tr = curate(e, lam=lam, pb=pb, k_max=k_max, device="cpu")
    assert tr.n_clusters == jr.n_clusters and tr.n_points == jr.n_points
    np.testing.assert_array_equal(tr.result.z.numpy(), np.asarray(jr.result.z))
    np.testing.assert_array_equal(tr.keep_weight, jr.keep_weight)
    assert tr.dup_fraction == jr.dup_fraction > 0
    assert bool(tr.result.pool.overflow) == bool(jr.result.pool.overflow)


def test_curation_downweights_duplicates():
    """The reference's tests/test_substrates.py case, on the port."""
    x, z, _ = dp_stick_breaking_data(512, seed=0)
    # inject near-duplicates
    x[:100] = x[0] + 0.01 * np.random.default_rng(0).normal(size=(100, 16))
    rep = curate(torch.as_tensor(x), lam=4.0, pb=64, k_max=128)
    assert rep.n_clusters >= 1
    assert rep.keep_weight.min() < 1.0       # the duplicate cluster got capped
    assert rep.keep_weight.max() <= 1.0
    jr = j_curate(jnp.asarray(x), lam=4.0, pb=64, k_max=128)
    assert rep.n_clusters == jr.n_clusters
    np.testing.assert_array_equal(rep.keep_weight, jr.keep_weight)


def test_curate_refuses_a_mesh():
    """Not a mesh of the pass's device type (tests/test_torch_mesh_occ.py
    curates on a mesh)."""
    with pytest.raises(ValueError, match="mesh"):
        curate(np.zeros((4, 2), np.float32), lam=1.0, pb=2, mesh=object(),
               device="cpu")


def _jax_example(name: str) -> str:
    """stdout of `examples/<name>.py`'s main() in this process."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_data_curation_example_equals_jax(granite):
    """The example on the JAX package's weights (the JAX example's
    `jax.random.key(0)`): its integers equal the JAX example's output."""
    _, _, tm = granite
    out = _jax_example("data_curation")
    m = re.search(r"embedded (\d+) sequences into R\^(\d+)", out)
    assert (int(m[1]), int(m[2])) == (96, 64)
    m2 = re.search(r"curation: (\d+) clusters over (\d+) sequences; "
                   r"dup_fraction=([\d.]+)%", out)
    m3 = re.search(r"down-weighted: (\d+) seqs", out)
    with contextlib.redirect_stdout(io.StringIO()):
        got = data_curation.main(["--device", "cpu"], model=tm)
    assert (got["n_embedded"], got["dim"]) == (96, 64)
    assert got["n_clusters"] == int(m2[1]) and got["n_points"] == int(m2[2])
    assert f"{got['dup_fraction']:.2%}" == f"{m2[3]}%"
    assert got["n_downweighted"] == int(m3[1])
