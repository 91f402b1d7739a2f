"""The port's top-k serving primitives against the JAX package, on the CPU.

On the CPU the port's `ops.serve_topk` / `serve_topk_multiprobe` run their
plain versions (`repro_torch.kernels.ref`); each case feeds the same numpy
arrays to them and to the JAX package's oracle (`backend="ref"`) and
Pallas kernel in interpret mode.  Bar: ids identical, f32 distances within
rtol = atol = 1e-5 (XLA and torch sum the D products in different orders).
The CUDA kernels themselves are held against the plain versions on the
card by `chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.topk_stream import topk_tile_loads as j_tile_loads  # noqa: E402
from repro.serving.snapshot import build_hier as j_build_hier  # noqa: E402
from repro_torch.convert import hier_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.topk_stream import (  # noqa: E402
    MAX_K, _bucket, topk_multiprobe_stream, topk_stream, topk_tile_loads,
)

TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS = dict(block_n=16, block_k=8)


def _case(n, kc, d, count, seed, holes=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(kc, d)).astype(np.float32)
    mask = np.arange(kc) < count
    if holes:
        mask &= rng.uniform(size=kc) > 0.3
    return x, c, mask


def _port_topk(x, c, k, mask=None, count=None, n_valid=None):
    d2, idx = tops.serve_topk(
        torch.from_numpy(x), torch.from_numpy(c), k,
        mask=None if mask is None else torch.from_numpy(mask),
        count=count, n_valid=n_valid)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    return d2.numpy(), idx.numpy()


def _jax_topk(x, c, k, backend, mask=None, count=None, n_valid=None):
    kw = PALLAS if backend == "pallas" else {}
    d2, idx = jops.serve_topk(
        jnp.asarray(x), jnp.asarray(c), k,
        mask=None if mask is None else jnp.asarray(mask),
        count=None if count is None else jnp.asarray(count, jnp.int32),
        n_valid=n_valid, backend=backend, **kw)
    return np.asarray(d2), np.asarray(idx)


def _agree(port, jax_out):
    np.testing.assert_array_equal(port[1], jax_out[1])
    np.testing.assert_allclose(port[0], jax_out[0], **TOL)


# The ragged cases of tests/test_kernels.py, and a few more.
RAGGED = {
    "ragged": (17, 20, 5, 13, 4),
    "many_tiles_awkward_d": (37, 300, 19, 211, 7),
    "k_gt_count": (9, 20, 6, 5, 8),
    "empty_pool": (20, 37, 6, 0, 3),
    "count_eq_capacity": (33, 130, 8, 130, 5),
    "k1": (25, 64, 16, 41, 1),
    "aligned": (64, 512, 64, 387, 8),
}


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("name", sorted(RAGGED))
def test_serve_topk_matches_jax(name, backend):
    n, kc, d, count, k = RAGGED[name]
    x, c, mask = _case(n, kc, d, count, seed=len(name))
    port = _port_topk(x, c, k, mask=mask, count=torch.tensor(count,
                                                             dtype=torch.int32))
    _agree(port, _jax_topk(x, c, k, backend, mask=mask, count=count))
    d2, idx = port
    assert ((idx >= 0) == np.isfinite(d2)).all()
    assert (idx[np.isfinite(d2)] < count).all()


@pytest.mark.parametrize("seed", range(6))
def test_serve_topk_holes_sweep_matches_jax_ref(seed):
    rng = np.random.default_rng(100 + seed)
    n, kc = int(rng.integers(1, 40)), int(rng.integers(1, 200))
    count, k = int(rng.integers(0, kc + 1)), int(rng.integers(1, 13))
    x, c, mask = _case(n, kc, 8, count, seed=seed, holes=True)
    k = min(k, kc)
    port = _port_topk(x, c, k, mask=mask, count=count)
    _agree(port, _jax_topk(x, c, k, "ref", mask=mask, count=count))


@pytest.mark.parametrize("name", ["ragged", "holes", "duplicates"])
def test_top1_column_equals_port_serve_assign(name):
    x, c, mask = _case(31, 64, 16, 41, seed=3, holes=name == "holes")
    if name == "duplicates":
        c[32:] = c[:32]
    xt, ct, mt = map(torch.from_numpy, (x, c, mask))
    d2k, ik = tops.serve_topk(xt, ct, 3, mask=mt, count=41)
    d2a, ia = tops.serve_assign(xt, ct, mt, count=41)
    assert torch.equal(ik[:, 0], ia)
    assert torch.equal(d2k[:, 0], d2a)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_k_exceeds_capacity_padded_columns(backend):
    x, c, _ = _case(7, 12, 5, 12, seed=5)
    port = _port_topk(x, c, 20, count=12)
    _agree(port, _jax_topk(x, c, 20, backend, count=12))
    d2, idx = port
    assert d2.shape == (7, 20)
    assert (idx[:, 12:] == -1).all() and np.isinf(d2[:, 12:]).all()
    assert (idx[:, :12] >= 0).all()


def test_duplicate_distance_ties_go_to_the_lower_id():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(8, 6)).astype(np.float32)
    c = np.repeat(base, 3, axis=0)            # rows 3i, 3i+1, 3i+2 equal
    x = rng.normal(size=(11, 6)).astype(np.float32)
    port = _port_topk(x, c, 6, count=24)
    np.testing.assert_array_equal(port[1], _jax_topk(x, c, 6, "ref",
                                                     count=24)[1])
    d2, idx = port
    tie = d2[:, 1:] == d2[:, :-1]
    assert (idx[:, 1:][tie] > idx[:, :-1][tie]).all()
    assert (idx[:, 0] % 3 == 0).all()


def test_garbage_slots_past_count_never_surface():
    x, c, _ = _case(9, 16, 6, 16, seed=6)
    poisoned = c.copy()
    poisoned[5:] = np.nan
    poisoned[6] = np.inf
    clean = _port_topk(x, c, 8, count=torch.tensor(5, dtype=torch.int32))
    dirty = _port_topk(x, poisoned, 8, count=torch.tensor(5,
                                                          dtype=torch.int32))
    np.testing.assert_array_equal(clean[0], dirty[0])
    np.testing.assert_array_equal(clean[1], dirty[1])
    _agree(dirty, _jax_topk(x, poisoned, 8, "ref", count=5))
    assert (dirty[1][:, 5:] == -1).all() and np.isfinite(dirty[0][:, :5]).all()


def test_host_count_prefix_slice_is_bitwise_the_tensor_count():
    x, c, mask = _case(16, 1024, 16, 53, seed=7)
    a = _port_topk(x, c, 6, mask=mask, count=53)
    b = _port_topk(x, c, 6, mask=mask, count=torch.tensor(53,
                                                          dtype=torch.int32))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("n_valid", [0, 5, 16])
def test_query_prefix_masking_matches_jax(n_valid):
    x, c, mask = _case(16, 40, 8, 30, seed=8)
    port = _port_topk(x, c, 4, mask=mask, count=30, n_valid=n_valid)
    _agree(port, _jax_topk(x, c, 4, "ref", mask=mask, count=30,
                           n_valid=jnp.asarray(n_valid, jnp.int32)))
    assert (port[1][n_valid:] == -1).all()
    ta = tops.serve_assign(torch.from_numpy(x), torch.from_numpy(c),
                           torch.from_numpy(mask), count=30, n_valid=n_valid)
    ja = jops.serve_assign(jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask),
                           count=jnp.asarray(30, jnp.int32),
                           n_valid=jnp.asarray(n_valid, jnp.int32),
                           backend="ref")
    np.testing.assert_array_equal(ta[1].numpy(), np.asarray(ja[1]))
    np.testing.assert_allclose(ta[0].numpy(), np.asarray(ja[0]), **TOL)


@pytest.mark.parametrize("count", [0, 1, 5, 64, 130, 300, 512])
@pytest.mark.parametrize("kc,block", [(512, 128), (37, 8), (1000, 64),
                                      (8, 64), (32, 64), (131072, 64)])
def test_topk_tile_loads_equals_jax(count, kc, block):
    count = min(count, kc)
    assert topk_tile_loads(count, kc, block) == j_tile_loads(count, kc, block)


def test_merge_ref_is_order_independent():
    rng = np.random.default_rng(9)
    d2 = torch.from_numpy(rng.integers(0, 5, size=(6, 40)).astype(np.float32))
    ids = torch.from_numpy(rng.permutation(40).astype(np.int32)).expand(6, -1)
    perm = torch.from_numpy(rng.permutation(40))
    run_d = torch.full((6, 7), torch.inf)
    run_i = torch.full((6, 7), tref.TOPK_SENTINEL, dtype=torch.int32)
    a = tref.topk_merge_ref(run_d, run_i, d2, ids, 7)
    b = tref.topk_merge_ref(run_d, run_i, d2[:, perm], ids[:, perm], 7)
    h = tref.topk_merge_ref(*tref.topk_merge_ref(run_d, run_i, d2[:, :17],
                                                 ids[:, :17], 7),
                            d2[:, 17:], ids[:, 17:], 7)
    for other in (b, h):
        assert torch.equal(a[0], other[0]) and torch.equal(a[1], other[1])


# ------------------------------------------------------------ multi-probe

def _hier(kc, d, count, seed):
    rng = np.random.default_rng(seed)
    cn = rng.normal(size=(kc, d)).astype(np.float32)
    m = np.arange(kc) < count
    h = j_build_hier(jnp.asarray(cn), jnp.asarray(m), count)
    fields = {f: np.asarray(getattr(h, f)) for f in
              ("coarse", "coarse_mask", "fine", "fine_ids", "fine_mask")}
    return cn, m, h, hier_from_numpy(**fields, n_cells=h.n_cells,
                                     shard_cap=h.shard_cap, device="cpu")


def _port_mp(th, x, cells, member, k, u_count=None, n_valid=None):
    d2, idx = tops.serve_topk_multiprobe(
        torch.from_numpy(x), th.fine, th.fine_ids, th.fine_mask,
        torch.from_numpy(cells), torch.from_numpy(member), k,
        u_count=u_count, n_valid=n_valid)
    return d2.numpy(), idx.numpy()


def _jax_mp(h, x, cells, member, k, backend, u_count=None):
    d2, idx = jops.serve_topk_multiprobe(
        jnp.asarray(x), h.fine, h.fine_ids, h.fine_mask, jnp.asarray(cells),
        jnp.asarray(member), k,
        u_count=None if u_count is None else jnp.asarray(u_count, jnp.int32),
        backend=backend)
    return np.asarray(d2), np.asarray(idx)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_multiprobe_full_union_matches_jax_and_port_flat(backend):
    kc, d, count = 512, 64, 437
    cn, m, h, th = _hier(kc, d, count, seed=10)
    x = np.random.default_rng(11).normal(size=(32, d)).astype(np.float32)
    cells = np.arange(h.n_cells, dtype=np.int32)
    member = np.ones((32, h.n_cells), bool)
    port = _port_mp(th, x, cells, member, 9, u_count=h.n_cells)
    _agree(port, _jax_mp(h, x, cells, member, 9, backend,
                         u_count=h.n_cells))
    flat = _port_topk(x, cn, 9, mask=m, count=count)
    np.testing.assert_array_equal(port[1], flat[1])
    np.testing.assert_allclose(port[0], flat[0], **TOL)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_multiprobe_partial_union_matches_jax(backend):
    kc, d, count = 256, 16, 201
    cn, m, h, th = _hier(kc, d, count, seed=12)
    rng = np.random.default_rng(13)
    b, k = 9, 5
    x = rng.normal(size=(b, d)).astype(np.float32)
    probed = np.sort(rng.choice(h.n_cells, size=3, replace=False))
    cells = np.full((h.n_cells,), -1, np.int32)
    cells[:3] = probed
    member = np.zeros((b, h.n_cells), bool)
    member[:, :3] = rng.uniform(size=(b, 3)) > 0.3
    member[4] = False                         # a query with no member cell
    port = _port_mp(th, x, cells, member, k, u_count=3)
    _agree(port, _jax_mp(h, x, cells, member, k, backend, u_count=3))
    assert (port[1][4] == -1).all() and np.isinf(port[0][4]).all()
    ids, msk = np.asarray(h.fine_ids), np.asarray(h.fine_mask)
    for q in range(b):
        cand = {int(i) for u in range(3) if member[q, u]
                for i in ids[probed[u]][msk[probed[u]]]}
        got = port[1][q][port[1][q] >= 0]
        assert len(got) == min(k, len(cand)) and set(got) <= cand


def test_multiprobe_query_prefix_masking():
    cn, m, h, th = _hier(128, 8, 100, seed=14)
    x = np.random.default_rng(15).normal(size=(12, 8)).astype(np.float32)
    cells = np.arange(h.n_cells, dtype=np.int32)
    member = np.ones((12, h.n_cells), bool)
    d2, idx = _port_mp(th, x, cells, member, 4, n_valid=7)
    assert (idx[7:] == -1).all() and np.isinf(d2[7:]).all()
    full = _port_mp(th, x, cells, member, 4)
    np.testing.assert_array_equal(idx[:7], full[1][:7])


# ----------------------------------------------------- dispatch and wrappers

def test_cpu_tensors_never_launch_and_cuda_backend_raises():
    x, c, mask = _case(16, 16, 4, 10, seed=16)
    xt, ct, mt = map(torch.from_numpy, (x, c, mask))
    _, _, _, th = _hier(64, 4, 50, seed=17)
    cells = torch.arange(th.n_cells, dtype=torch.int32)
    member = torch.ones((16, th.n_cells), dtype=torch.bool)
    tops.reset_launch_counts()
    tops.serve_topk(xt, ct, 4, mask=mt, count=10)
    tops.serve_topk_multiprobe(xt, th.fine, th.fine_ids, th.fine_mask, cells,
                               member, 4)
    assert tops.TOPK_LAUNCHES == 0 and tops.TOPK_MP_LAUNCHES == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.serve_topk(xt, ct, 4, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.serve_topk_multiprobe(xt, th.fine, th.fine_ids, th.fine_mask,
                                   cells, member, 4, backend="cuda")
    # the kernel wrappers refuse a CPU tensor before any build
    cnt = torch.tensor([10], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        topk_stream(xt, ct, mt, cnt, 4)
    with pytest.raises(ValueError, match="CUDA"):
        topk_multiprobe_stream(xt, th.fine, th.fine_ids, th.fine_mask, cells,
                               member, cnt, 4)
    plain = tops.serve_topk(xt, ct, 4, mask=mt, count=10, backend="plain")
    auto = tops.serve_topk(xt, ct, 4, mask=mt, count=10)
    assert torch.equal(plain[0], auto[0]) and torch.equal(plain[1], auto[1])


@pytest.mark.parametrize("k,bucket", [(1, 1), (3, 4), (8, 8), (20, 32),
                                      (64, 64)])
def test_k_buckets(k, bucket):
    assert _bucket(k) == bucket


@pytest.mark.parametrize("k", [0, MAX_K + 1])
def test_k_outside_the_kernel_buckets_raises(k):
    with pytest.raises(ValueError, match="1 <= k"):
        _bucket(k)
