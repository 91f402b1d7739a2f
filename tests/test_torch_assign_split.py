"""The split schedule of the port's `dpmeans_assign` kernel, on the CPU.

The CUDA kernel splits the center range over S blocks per 64-row block:
split s takes center tiles s, s + S, s + 2S, ... below ceil(count/BK),
keeps the lexicographic minimum of (d2, id) over them, and the last block
merges the S partials.  These tests hold the split rule (`n_split`, a plain
function of the shapes and the SM count) to its contract, and a torch
emulation of that schedule over one precomputed masked distance matrix to
the single lexicographic minimum of each row, bit for bit, for every S;
its ids equal the JAX package's `dpmeans_assign_emulate`.  The kernel
merges the splits by an atomicMin over 64-bit keys bits(d2) << 32 | id;
`pack` mirrors that packing, and a test holds its order to (d2, id)'s.
The width chooses the kernel (`tile_kernel`): the fast tile at D = 16, the
wide tile (16 rows x 32 centers a block) at D >= 64 with D a multiple of 8,
the generic tile elsewhere; the tests hold that rule and the wide tile's
split to their contracts.  The kernel itself is held against its plain
version, and the wide tile against the generic one bit for bit, on the
card by `chip_smoke.py`.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dpmeans_assign import dpmeans_assign_emulate  # noqa: E402
from repro_torch.core.objective import sq_dists  # noqa: E402
from repro_torch.kernels.dpmeans_assign import (  # noqa: E402
    BLOCK_N, FAST_D, WIDE_BLOCK_N, WIDE_MIN_D, block_k, block_n, n_split,
    tile_kernel,
)

H100_SMS = 132
INT32_MAX = 2**31 - 1

# (rows, K, D) of the main path's launches and the split each gets on an
# H100: the paper's propose (one or two tiles: no merge), the retrieval
# index's propose, a score request, one row alone, the hierarchical
# routing, and curation's propose at D = 2048 (the wide tile: a split a
# tile, 16 row blocks x 16 splits).
SHAPES = {
    "paper": ((2048, 512, 16), 1),
    "retrieval": ((256, 131072, 16), 66),
    "score": ((64, 131072, 16), 256),
    "one_row": ((1, 131072, 16), 256),
    "routing": ((110000, 512, 16), 1),
    "curation": ((256, 512, 2048), 16),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_split_values_at_the_main_path_shapes(name):
    (rows, k, d), want = SHAPES[name]
    assert n_split(rows, k, d, H100_SMS) == want


def test_split_rule_takes_shapes_only():
    assert list(inspect.signature(n_split).parameters) == ["rows", "k", "d",
                                                          "sms"]
    assert block_k(FAST_D) == 256
    assert {block_k(d) for d in (1, 8, 15, 17, 33, 40, 100, 2052)} == {64}
    assert {block_k(d) for d in (64, 768, 2048, 4096)} == {32}


@pytest.mark.parametrize("d,kernel", [
    (1, "generic"), (8, "generic"), (15, "generic"), (16, "fast"),
    (17, "generic"), (33, "generic"), (40, "generic"), (56, "generic"),
    (60, "generic"), (64, "wide"), (100, "generic"), (768, "wide"),
    (1000, "wide"), (2048, "wide"), (2052, "generic"), (4096, "wide")])
def test_width_chooses_the_kernel(d, kernel):
    """D = 16 takes the fast tile; D >= 64 and a multiple of 8 (rows of
    whole 16-byte pieces in every element type) the wide tile; the D = 8
    of the examples and serve_clusters, the D = 40 of the f16 checks and
    odd widths the generic tile.  Each kernel's block rows and tile."""
    assert tile_kernel(d) == kernel
    assert (kernel == "wide") == (d >= WIDE_MIN_D and d % 8 == 0)
    assert block_n(d) == (WIDE_BLOCK_N if kernel == "wide" else BLOCK_N)
    assert block_k(d) == {"fast": 256, "wide": 32, "generic": 64}[kernel]


def test_wide_split_fills_the_card_at_curation():
    """Curation's propose (256 rows, 512 slots, D = 2048) runs at least a
    block an SM of the H100, each split owning one tile of 32 centers."""
    rows, k, d = SHAPES["curation"][0]
    s = n_split(rows, k, d, H100_SMS)
    row_blocks = -(-rows // block_n(d))
    assert row_blocks * s >= H100_SMS
    assert s == -(-k // block_k(d))


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_wide_split_bounds_and_grid_fill(sms):
    """At most a split a tile; about four blocks an SM where the tiles
    allow it, with one split fewer short of it."""
    for rows in (1, 15, 16, 17, 63, 256, 1000, 2048, 9000):
        for k in (1, 31, 32, 33, 256, 512, 1000, 4096):
            for d in (64, 768, 2048, 4096):
                s = n_split(rows, k, d, sms)
                tiles = -(-k // 32)
                row_blocks = -(-rows // WIDE_BLOCK_N)
                assert 1 <= s <= tiles
                if tiles >= -(-4 * sms // row_blocks):
                    assert row_blocks * s >= 4 * sms
                    assert s == 1 or row_blocks * (s - 1) < 4 * sms


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_split_bounds_and_grid_fill(sms):
    for rows in (1, 63, 64, 65, 256, 1000, 2048, 9000, 110000):
        for k in (1, 8, 63, 64, 65, 255, 256, 512, 1000, 4096, 131072):
            for d in (16, 33):
                s = n_split(rows, k, d, sms)
                tiles = -(-k // block_k(d))
                row_blocks = -(-rows // BLOCK_N)
                assert 1 <= s <= tiles
                if s > 1:
                    assert tiles >= 2 * s
                # about 2 blocks an SM: where the tiles allow it, the grid
                # reaches 2 x SMs blocks with one split fewer short of it
                if tiles // 2 >= -(-2 * sms // row_blocks):
                    assert row_blocks * s >= 2 * sms
                    assert s == 1 or row_blocks * (s - 1) < 2 * sms


def _lexmin(d, ids):
    """Per row, the lexicographic minimum of (d, id) over the columns."""
    if d.shape[1] == 0:
        n = d.shape[0]
        return (torch.full((n,), torch.inf),
                torch.full((n,), INT32_MAX, dtype=torch.int64))
    dmin = d.min(1).values
    tie = d == dmin[:, None]
    big = torch.full_like(d, INT32_MAX, dtype=torch.int64)
    return dmin, torch.where(tie, ids[None, :].expand_as(big), big).min(1).values


def pack(d, i):
    """The kernel's merge key of (d2, id): the f32 bits of d2 (+0, positive
    or +inf: the clamp never yields -0 or NaN) above the id, as uint64."""
    bits = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | np.asarray(i, np.int64).astype(np.uint64)


def unpack(key):
    d = (key >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return d, (key & np.uint64(0xFFFFFFFF)).astype(np.int64)


def test_packed_keys_order_as_d2_then_id():
    tiny = np.finfo(np.float32).smallest_subnormal
    ds = np.array([0.0, tiny, 2 * tiny, np.finfo(np.float32).tiny, 1e-30,
                   0.5, 1.0, 1.0 + 2**-23, 3.0e38, np.finfo(np.float32).max,
                   np.inf], np.float32)
    ids = np.array([0, 1, 2, 12345, 2**31 - 2, 2**31 - 1], np.int64)
    d, i = (a.ravel() for a in np.meshgrid(ds, ids, indexing="ij"))
    rng = np.random.default_rng(0)
    order = rng.permutation(d.size)
    d, i = d[order], i[order]
    keys = pack(d, i)
    by_key = np.argsort(keys, kind="stable")
    by_lex = np.lexsort((i, d))
    np.testing.assert_array_equal(by_key, by_lex)
    ud, ui = unpack(keys)
    np.testing.assert_array_equal(ud.view(np.uint32), d.view(np.uint32))
    np.testing.assert_array_equal(ui, i)
    # the untouched key (all ones) is above every packed one
    assert keys.max() < np.uint64(2**64 - 1)


def schedule_emulate(d2, valid, count, s, bk, seed=0):
    """The kernel's schedule over a precomputed (N, K) distance matrix:
    invalid slots and slots at or past the count are inf; split sp walks
    tiles sp, sp + s, ... below ceil(count/bk), keeping its running
    minimum with a strict < over tiles in ascending order (in-tile ties to
    the lowest id); the s partials are then merged as the kernel merges
    them, by the minimum of their packed keys, folded in a shuffled order.
    Returns (d2 (N,), idx (N,)), (inf, -1) where no valid center exists."""
    n, k = d2.shape
    active = max(0, min(int(count), k))
    n_tiles = -(-active // bk)
    cols = torch.arange(k)
    d = torch.where(valid[None, :] & (cols < active)[None, :], d2, torch.inf)
    parts = []
    for sp in range(s):
        run_d = torch.full((n,), torch.inf)
        run_i = torch.full((n,), INT32_MAX, dtype=torch.int64)
        for t in range(sp, n_tiles, s):
            ids = cols[t * bk:(t + 1) * bk]
            td, ti = _lexmin(d[:, ids], ids)
            better = td < run_d
            run_d = torch.where(better, td, run_d)
            run_i = torch.where(better, ti, run_i)
        parts.append((run_d, run_i))
    keys = np.full((n,), 2**64 - 1, np.uint64)
    for p in np.random.default_rng(seed).permutation(s):
        keys = np.minimum(keys, pack(parts[p][0].numpy(), parts[p][1].numpy()))
    out_d, out_i = (torch.from_numpy(a.copy()) for a in unpack(keys))
    return out_d, torch.where(out_d < torch.inf, out_i, -1)


def _case(name):
    """(x, centers, mask, count) as numpy, and the distance matrix: the
    port's expanded form, with exact ties where the case asks for them."""
    rng = np.random.default_rng(len(name))
    n, k, d = 96, 2048, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    mask = np.ones(k, bool)
    count = k
    if name == "holes":
        mask &= rng.uniform(size=k) > 0.3
        count = 1900
    elif name == "ragged":
        count = 1000          # not a multiple of either tile
    elif name == "count0":
        count = 0
    elif name == "count_past_k":
        count = k + 5
    elif name == "count1":
        count = 1
    d2 = sq_dists(torch.from_numpy(x), torch.from_numpy(c))
    if name == "duplicates":
        # centers i and i + K/2 are one center: exact ties across tiles
        # and across splits, which the lowest id must win
        c[k // 2:] = c[:k // 2]
        d2 = torch.cat([d2[:, :k // 2], d2[:, :k // 2]], 1)
    return x, c, mask, count, d2


CASES = ("plain", "holes", "ragged", "count0", "count_past_k", "count1",
         "duplicates")


@pytest.mark.parametrize("bk", [256, 64, 32])
@pytest.mark.parametrize("name", CASES)
def test_schedule_is_bitwise_independent_of_the_split(name, bk):
    x, c, mask, count, d2 = _case(name)
    valid = torch.from_numpy(mask)
    k = c.shape[0]
    active = max(0, min(count, k))
    cols = torch.arange(k)
    want_d, want_i = _lexmin(
        torch.where(valid[None, :] & (cols < active)[None, :], d2, torch.inf),
        cols)
    want_i = torch.where(want_d < torch.inf, want_i, -1)
    n_tiles = -(-k // bk)
    for s in sorted({1, 2, 3, 7, 66, n_tiles}):
        got_d, got_i = schedule_emulate(d2, valid, count, s, bk, seed=s)
        assert torch.equal(got_d, want_d), (name, s)
        assert torch.equal(got_i, want_i), (name, s)
    if name == "duplicates":
        assert bool((want_i < k // 2).all())
    if name == "count0":
        assert bool(torch.isinf(want_d).all()) and bool((want_i == -1).all())
    if name == "count1":
        assert bool((want_i == 0).all())
    # The JAX package's emulation of the TPU kernel picks the same ids, on
    # a mask that holds the pool invariant (False at and past the count:
    # the TPU kernel skips whole tiles by the count, not slots).
    # Not for the duplicates: XLA on the CPU need not give two copies of a
    # center the same distance bits (the reference's own tie tests fail
    # there), so which copy it picks says nothing about the schedule.
    if name != "duplicates":
        _, jid = dpmeans_assign_emulate(
            jnp.asarray(x), jnp.asarray(c),
            jnp.asarray(mask & (np.arange(k) < count)),
            jnp.asarray(count, jnp.int32))
        np.testing.assert_array_equal(np.asarray(jid), want_i.numpy())
