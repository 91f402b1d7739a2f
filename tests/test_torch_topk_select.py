"""The selection and merge schedule of the port's top-k kernels, on the CPU.

The CUDA kernels (`kernels/csrc/topk_stream.cu`) select behind a threshold
in registers: four lanes own a row of the flat kernel (every lane of a
warp owns the query of a multi-probe pair), each keeps an ascending list
of its k best (d2, id) and takes a candidate only if it beats the row's
threshold (full lexicographic compare); the lists of a row then merge by
bitonic steps over shuffles.  The flat kernel's S splits merge in the same
launch by a tree of at most two levels of ticketed last blocks, each
folding lists into the four lanes' lists; multi-probe walks union ranks
instead of tiles, forms distances for member pairs only, appends every
pair's list to its query's lists, and the last block folds them.

These tests emulate that schedule in numpy over one precomputed distance
matrix -- the lanes' candidate sets, the lane merge, the merge tree and
the folds in any order -- and hold it bit for bit to the plain versions
(`ref.topk_ref`, `ref.topk_multiprobe_ref`) for S from 1 to every tile and
k in {1, 3, 8, 64}, with exact ties, holes and random membership; the ids
agree with the JAX package's emulations of the TPU kernels.  They also pin
the split rules' values at the serving shapes, emulate the wide route
for k > 64 (a list in memory a (row, split), rounds of candidates below
its last key sorted and folded in by the kernel's own bitonic index
arithmetic, the splits' lists folded by the last block) bit for bit
against the plain version, and hold the port's plain
f16 versions of the nearest-center and rmsnorm kernels to the JAX
package's references.  The kernels themselves are held against the plain
versions on the card by `chip_smoke.py`.
"""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.topk_stream import (  # noqa: E402
    topk_multiprobe_emulate, topk_stream_emulate,
)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.topk_stream import (  # noqa: E402
    _WIDE_CHUNK, _bucket, block_k, mp_n_split, n_split, wide_list,
    wide_n_split,
)

H100_SMS = 132
SENT = 2**31 - 1
INF = np.float32(np.inf)


# ------------------------------------------------------------ split rules
# (rows, capacity, D) of the flat kernel's launches (k > 1) on the serving
# path, and the tile width and split each gets on an H100: flat top-k and
# the recall audit (a 64-row microbatch over the 131,072-slot retrieval
# index: the fast tile), the multi-probe routing (64 queries against 512
# coarse cells: two fast tiles, so the generic tile on 8 blocks), a
# 256-row batch, one row alone, a generic width, and a pool of one tile.
FLAT = {
    "serve_flat": ((64, 131072, 16), (256, 128)),
    "routing": ((64, 512, 16), (64, 8)),
    "batch_256": ((256, 131072, 16), (256, 66)),
    "one_row": ((1, 131072, 16), (256, 128)),
    "small_pool": ((100, 4096, 16), (256, 4)),
    "generic_d40": ((70, 2000, 40), (64, 32)),
    "one_tile": ((17, 20, 5), (64, 1)),
}
# (queries, union capacity) of the multi-probe kernel: the serving
# microbatch at p = 4 (a union of at most 256 of 512 cells), p = all, a
# small union, and many row blocks.
MP = {
    "serve_p4": ((64, 256), 256),
    "serve_p_all": ((64, 512), 264),
    "small_union": ((9, 3), 3),
    "rows_4096": ((4096, 256), 5),
}


@pytest.mark.parametrize("name", sorted(FLAT))
def test_flat_split_values_at_the_serving_shapes(name):
    (rows, k, d), (bk, s) = FLAT[name]
    assert block_k(rows, k, d, H100_SMS) == bk
    assert n_split(rows, k, d, H100_SMS) == s


@pytest.mark.parametrize("name", sorted(MP))
def test_multiprobe_split_values(name):
    (rows, u), want = MP[name]
    assert mp_n_split(rows, u, H100_SMS) == want


def test_split_rules_take_shapes_only():
    for fn in (n_split, block_k):
        assert list(inspect.signature(fn).parameters) == ["rows", "k", "d",
                                                         "sms"]
    assert list(inspect.signature(mp_n_split).parameters) == ["rows", "u",
                                                             "sms"]
    for rows in (1, 64, 65, 4096):
        for u in (1, 3, 256, 512):
            assert 1 <= mp_n_split(rows, u, H100_SMS) <= u


# ------------------------------------------------------ the schedule, numpy
def _keys(d, i):
    """(d2, id) as uint64 keys ordered lexicographically (d2 >= 0)."""
    bits = np.asarray(d, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | np.asarray(i, np.int64).astype(np.uint64)


PAD = _keys(np.float32(np.inf), SENT)


def lane_lists(keys, ok, kk):
    """Each lane's register list over its candidates in order: (L, M)
    candidate keys, valid where `ok`; a candidate enters only if it beats
    the list's last entry.  Returns (L, kk) ascending keys, PAD-filled."""
    lst = np.full((keys.shape[0], kk), PAD)
    for m in range(keys.shape[1]):
        c = keys[:, m]
        take = ok[:, m] & (c < lst[:, -1])
        new = np.sort(np.concatenate([lst[:, :-1], c[:, None]], 1), 1)
        lst = np.where(take[:, None], new, lst)
    return lst


def merge_group(lists, width):
    """(R, width, kk) lists of `width` lanes merged by the kernel's xor
    butterfly: with the lane `off` away, min(mine[m], theirs[kk-1-m]) (a
    bitonic sequence of the kk smallest of both, the sets being disjoint),
    then sorted, as the bitonic merge does.  Every lane ends with the
    group's list."""
    off = 1
    while off < width:
        partner = lists[:, np.arange(width) ^ off]
        lists = np.sort(np.minimum(lists, partner[:, :, ::-1]), axis=2)
        off <<= 1
    return lists


def _out(keys, k):
    keys = keys[:, :k]
    found = keys != PAD
    d = np.where(found, (keys >> np.uint64(32)).astype(np.uint32)
                 .view(np.float32), np.float32(np.inf))
    i = np.where(found, (keys & np.uint64(0xFFFFFFFF)).astype(np.int64), -1)
    return torch.from_numpy(d.astype(np.float32)), torch.from_numpy(
        i.astype(np.int32))


PARTS = 4


def fold(lists, kk):
    """The last block of a merge: for each row, lane part folds lists part,
    part + 4, ... (each (N, kk) ascending) into its register list in
    order; the four lane lists merge."""
    order = [l for part in range(PARTS) for l in range(part, len(lists),
                                                          PARTS)]
    cand = np.concatenate([lists[l] for l in order], 1)
    lane_of = np.concatenate([np.full(kk, l % PARTS) for l in order])
    lanes = np.stack([lane_lists(cand[:, lane_of == part],
                                 cand[:, lane_of == part] != PAD, kk)
                      for part in range(PARTS)], 1)
    return merge_group(lanes, PARTS)[:, 0]


def flat_emulate(d2, ok, count, k, s, bk):
    """The flat kernel's schedule over a (N, K) distance matrix: split sp
    walks tiles sp, sp + s, ... below ceil(active / bk); lane `part` of a
    row takes the tile's candidates part, part + 4, ...; the four lists
    merge.  With s > 1 the last block's lane `part` takes the lists of
    splits part, part + 4, ... as its candidates, and the four lists
    merge again: in groups of up to 16 splits, or of about sqrt(s) splits
    whose group lists are folded the same way."""
    n, kc = d2.shape
    kk = _bucket(k)
    active = max(0, min(int(count), kc))
    n_tiles = -(-active // bk)
    cols = np.arange(kc)
    valid = ok & (cols < active)
    keys = np.where(valid[None, :], _keys(d2, np.broadcast_to(cols, d2.shape)),
                    PAD)

    def four_lanes(cand, cand_ok):
        lanes = np.stack([lane_lists(cand[:, part::PARTS],
                                     cand_ok[:, part::PARTS], kk)
                          for part in range(PARTS)], 1)
        return merge_group(lanes, PARTS)[:, 0]

    split = []
    for sp in range(s):
        mine = [cols[t * bk:(t + 1) * bk] for t in range(sp, n_tiles, s)]
        mine = np.concatenate(mine) if mine else np.zeros(0, int)
        split.append(four_lanes(keys[:, mine],
                                np.broadcast_to(valid[mine], (n, mine.size))))
    if s == 1:
        return _out(split[0], k)
    # the merge tree: groups of gs splits, then the groups' lists
    gs = s if s <= 16 else math.isqrt(s - 1) + 1
    groups = [fold(split[g:g + gs], kk) for g in range(0, s, gs)]
    return _out(groups[0] if len(groups) == 1 else fold(groups, kk), k)


def _flat_case(name, n=64, kc=1024, d=16):
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(kc, d)).astype(np.float32)
    mask = np.ones(kc, bool)
    count = kc
    if name == "holes":
        mask &= rng.uniform(size=kc) > 0.3
        count = 900
    elif name == "ragged":
        count = 500
    elif name == "count0":
        count = 0
    return x, c, mask, count


def _plain_d2(x, c, mask):
    """`ref.topk_ref`'s distance matrix (masked rows zeroed, then inf)."""
    xt, ct, mt = (torch.from_numpy(a) for a in (x, c, mask))
    ct = torch.where(mt[:, None], ct, 0)
    x2 = torch.sum(xt * xt, dim=-1, keepdim=True)
    c2 = torch.sum(ct * ct, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + c2 - 2.0 * (xt @ ct.T), 0.0)
    return torch.where(mt[None, :], d2, torch.inf).numpy()


@pytest.mark.parametrize("bk", [256, 64])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("name", ["plain", "holes", "ragged", "count0"])
def test_flat_schedule_is_bitwise_the_plain_topk(name, k, bk):
    x, c, mask, count = _flat_case(name)
    m = mask & (np.arange(c.shape[0]) < count)
    want = tref.topk_ref(torch.from_numpy(x), torch.from_numpy(c), k,
                         torch.from_numpy(m))
    d2 = _plain_d2(x, c, m)
    n_tiles = -(-c.shape[0] // bk)
    for s in sorted({1, 2, 3, 17, n_tiles}):
        got = flat_emulate(d2, m, count, k, s, bk)
        assert torch.equal(got[0], want[0]), s
        assert torch.equal(got[1], want[1]), s
    if name == "count0":
        assert bool(torch.isinf(want[0]).all()) and bool((want[1] == -1).all())
    # The JAX package's emulation of the TPU kernel picks the same ids.
    if name != "count0":
        _, jid = topk_stream_emulate(jnp.asarray(x), jnp.asarray(c),
                                     jnp.asarray(m), k,
                                     count=jnp.asarray(count, jnp.int32))
        np.testing.assert_array_equal(np.asarray(jid), want[1].numpy())


@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_flat_schedule_exact_ties_go_to_the_lower_id(k):
    # centers i and i + K/2 are one center: exact ties across lanes, tiles
    # and splits, which the lower id must win
    x, c, mask, count = _flat_case("duplicates", kc=512)
    d2 = _plain_d2(x, c, mask)
    half = c.shape[0] // 2
    d2 = np.concatenate([d2[:, :half], d2[:, :half]], 1)
    n = x.shape[0]
    kk = _bucket(k)
    ids = np.broadcast_to(np.arange(c.shape[0], dtype=np.int32),
                          d2.shape).copy()
    want = tref.topk_merge_ref(torch.full((n, kk), torch.inf),
                               torch.full((n, kk), SENT, dtype=torch.int32),
                               torch.from_numpy(d2), torch.from_numpy(ids), kk)
    fin = torch.isfinite(want[0][:, :k])
    want = (want[0][:, :k], torch.where(fin, want[1][:, :k], -1))
    for s in (1, 2, 7):
        got = flat_emulate(d2, mask, count, k, s, 64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tie = want[0][:, 1:] == want[0][:, :-1]
    assert bool((~tie | (want[1][:, 1:] > want[1][:, :-1])).all())
    assert bool((want[1][:, 0] < half).all())


@pytest.mark.parametrize("kk", [1, 8, 64])
def test_fold_takes_the_smallest_entries_whatever_the_list_order(kk):
    # lists of disjoint candidates, appended in any order and any number
    rng = np.random.default_rng(kk)
    n, n_lists = 16, 11
    keys = (rng.permutation(10 * n_lists * kk * n).astype(np.uint64)
            [:n * n_lists * kk].reshape(n, n_lists, kk) * np.uint64(7919))
    keys = np.sort(keys, 2)
    keys[:, 3, kk // 2:] = PAD               # a list with pads
    want = np.sort(keys.reshape(n, -1), 1)[:, :kk]
    for seed in range(4):
        order = np.random.default_rng(seed).permutation(n_lists)
        got = fold([keys[:, l] for l in order], kk)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------- multi-probe, rank-inverted
def mp_emulate(d2, gok, gids, member, cells, u_count, k, s, seed=0):
    """The multi-probe kernel's schedule over the (B, U * S_cap) distance
    matrix of the gathered union: split sp takes ranks sp, sp + s, ...
    below u_count with a cell; each member pair runs on a warp whose lane l
    takes the shard's valid rows l, l + 32, ... (non-member pairs form no
    candidate); the 32 lists merge, and the pair's list is appended to the
    query's lists (in any order: the splits race); the last block folds
    each row's lists."""
    b, total = d2.shape
    u = cells.shape[0]
    s_cap = total // u
    kk = _bucket(k)
    uc = max(0, min(int(u_count), u))
    steps = -(-s_cap // 32)
    lists = [[] for _ in range(b)]
    for sp in range(s):
        for j in range(sp, uc, s):
            if cells[j] < 0:
                continue
            cols = np.arange(j * s_cap, j * s_cap + 32 * steps)
            inside = cols < (j + 1) * s_cap
            cols = np.where(inside, cols, j * s_cap)
            for q in np.nonzero(member[:, j])[0]:
                kq = _keys(d2[q, cols], gids[cols]).reshape(steps, 32).T
                okq = (gok[cols] & inside).reshape(steps, 32).T
                lst = merge_group(lane_lists(kq, okq, kk)[None], 32)[0, 0]
                if lst[0] != PAD:
                    lists[q].append(lst)
    rng = np.random.default_rng(seed)
    rows = []
    for q in range(b):
        order = rng.permutation(len(lists[q]))
        rows.append(fold([lists[q][l][None] for l in order], kk)[0]
                    if len(order) else np.full(kk, PAD))
    return _out(np.stack(rows), k)


def _mp_case(name):
    from repro.serving.snapshot import build_hier as j_build_hier
    rng = np.random.default_rng(20 + len(name))
    kc, d, count = 512, 16, 437
    b = 12 if name == "full" else 40
    cn = rng.normal(size=(kc, d)).astype(np.float32)
    m = np.arange(kc) < count
    h = j_build_hier(jnp.asarray(cn), jnp.asarray(m), count)
    x = rng.normal(size=(b, d)).astype(np.float32)
    u = h.n_cells
    if name == "full":
        cells = np.arange(u, dtype=np.int32)
        member = np.ones((b, u), bool)
        uc = u
    else:
        probed = np.sort(rng.choice(u, size=6, replace=False))
        cells = np.full((u,), -1, np.int32)
        cells[:6] = probed
        cells[2] = -1                       # a -1 inside the counted ranks
        member = np.zeros((b, u), bool)
        member[:, :6] = rng.uniform(size=(b, 6)) > 0.5
        member[3] = False                   # a query with no member cell
        member[5, :6] = True                # one query a member of every rank
        member[:, 7:] = True                # flags past u_count: not read
        uc = 6
    return cn, m, h, x, cells, member, uc


@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("name", ["full", "random_membership"])
def test_multiprobe_schedule_is_bitwise_the_plain_version(name, k):
    cn, m, h, x, cells, member, uc = _mp_case(name)
    fine = torch.from_numpy(np.array(h.fine))
    fids = torch.from_numpy(np.array(h.fine_ids))
    fmask = torch.from_numpy(np.array(h.fine_mask))
    xt = torch.from_numpy(x)
    # the plain version reads every listed rank; the kernels stop at
    # u_count, so the plain version gets the ranks past it cleared
    cells_p = cells.copy()
    cells_p[uc:] = -1
    want = tref.topk_multiprobe_ref(xt, fine, fids, fmask,
                                    torch.from_numpy(cells_p),
                                    torch.from_numpy(member), k)
    # the plain version's distance matrix over the gathered union
    u, s_cap = cells.shape[0], fine.shape[1]
    cc = torch.clamp_min(torch.from_numpy(cells_p), 0).long()
    gok = (fmask[cc] & (torch.from_numpy(cells_p) >= 0)[:, None]).reshape(-1)
    g = torch.where(gok[:, None], fine[cc].reshape(u * s_cap, -1), 0)
    x2 = torch.sum(xt * xt, dim=-1, keepdim=True)
    g2 = torch.sum(g * g, dim=-1)[None, :]
    d2 = torch.clamp_min(x2 + g2 - 2.0 * (xt @ g.T), 0.0).numpy()
    gids = fids[cc].reshape(-1).numpy().astype(np.int64)
    for s in (1, u):
        got = mp_emulate(d2, gok.numpy(), gids, member, cells, uc, k, s,
                         seed=s)
        assert torch.equal(got[0], want[0]), s
        assert torch.equal(got[1], want[1]), s
    # The JAX package's emulations pick the same ids: the multi-probe one
    # (which reads a -1 rank as cell 0, so its flags are cleared there, as
    # the service never sets them), and over the full union the flat one.
    _, jid = topk_multiprobe_emulate(
        jnp.asarray(x), h.fine, h.fine_ids, h.fine_mask, jnp.asarray(cells),
        jnp.asarray(member & (cells >= 0)[None, :]), k,
        u_count=jnp.asarray(uc, jnp.int32))
    np.testing.assert_array_equal(np.asarray(jid), want[1].numpy())
    if name == "full":
        _, fid = topk_stream_emulate(jnp.asarray(x), jnp.asarray(cn),
                                     jnp.asarray(m), k)
        np.testing.assert_array_equal(np.asarray(fid), want[1].numpy())
    else:
        assert bool(torch.isinf(want[0][3]).all())
        assert bool((want[1][3] == -1).all())


# ------------------------------------------------------------- f16, plain
@pytest.mark.parametrize("n,k,d", [(17, 5, 3), (64, 32, 16), (100, 37, 16),
                                   (256, 128, 64), (33, 130, 8)])
def test_pairwise_argmin_plain_f16_matches_jax_ref(rng, n, k, d):
    x = rng.normal(size=(n, d)).astype(np.float16)
    c = rng.normal(size=(k, d)).astype(np.float16)
    m = rng.uniform(size=k) > 0.25
    d2p, ip = tops.pairwise_argmin(torch.from_numpy(x), torch.from_numpy(c),
                                   torch.from_numpy(m), backend="plain")
    d2r, ir = jref.pairwise_argmin_ref(jnp.asarray(x), jnp.asarray(c),
                                       jnp.asarray(m))
    assert d2p.dtype == torch.float32
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ir))
    np.testing.assert_allclose(d2p.numpy(), np.asarray(d2r), atol=5e-3)


@pytest.mark.parametrize("shape", [(7, 33), (64, 256), (3, 5, 128)])
def test_rmsnorm_plain_f16_matches_jax_ref(rng, shape):
    x = rng.normal(size=shape).astype(np.float16)
    w = rng.normal(size=shape[-1]).astype(np.float16)
    got = tops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                       backend="plain")
    want = jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


# ----------------------------------------------- k > 64: the wide route
# (rows, candidates) of the wide route's launches and their splits on an
# H100: the serving microbatch over the retrieval index, one row alone, a
# pool smaller than k, a 3000-wide list over 14 splits, and multi-probe's
# 64 queries over a union of 256 shards of 320 rows.
WIDE = {"serve_flat": ((64, 131072), 5), "one_row": ((1, 131072), 16),
        "small_pool": ((37, 64), 1), "k3000": ((20, 131072), 14),
        "mp_union": ((64, 256 * 320), 5)}
NONE = np.uint64(2**64 - 1)


@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_split_values(name):
    (rows, cands), want = WIDE[name]
    assert wide_n_split(rows, cands, H100_SMS) == want
    assert list(inspect.signature(wide_n_split).parameters) == [
        "rows", "cands", "sms"]


@pytest.mark.parametrize("k,cands,want", [(65, 131072, 128),
                                          (100, 131072, 128),
                                          (256, 131072, 256),
                                          (3000, 131072, 4096),
                                          (100, 64, 64), (100, 0, 1)])
def test_wide_list_lengths(k, cands, want):
    assert wide_list(k, cands) == want


def _stage(a, size, stride):
    """One stage of the kernel's bitonic network (`wide::stage`): pair t
    compares i = 2t - (t & (stride - 1)) with i + stride, ascending where
    (i & size) == 0."""
    a = a.copy()
    for t in range(a.shape[0] // 2):
        i = 2 * t - (t & (stride - 1))
        j = i + stride
        if (a[i] > a[j]) == ((i & size) == 0):
            a[i], a[j] = a[j], a[i]
    return a


def _sort(a):
    m = a.shape[0]
    size = 2
    while size <= m:
        stride = size // 2
        while stride:
            a = _stage(a, size, stride)
            stride //= 2
        size *= 2
    return a


def _merge(a):
    stride = a.shape[0] // 2
    while stride:
        a = _stage(a, a.shape[0], stride)
        stride //= 2
    return a


def _fold(lst, b):
    """`wide::fold`: min(list[t], b[kk-1-t]) (NONE past b), then one
    bitonic merge."""
    kk = lst.shape[0]
    rev = np.full(kk, NONE)
    n = min(kk, b.shape[0])
    rev[kk - n:] = b[:n][::-1]
    return _merge(np.minimum(lst, rev))


def wide_emulate(keys, k, s, chunk, rng):
    """The wide route on a (rows, candidates) matrix of keys (NONE where a
    candidate is invalid): per (row, split) a list of wide_list(k, m)
    keys built in rounds of `chunk` candidates (those below the list's
    last key appended in a random order, as the atomic appends land),
    then the splits' lists folded in a random order."""
    n, m = keys.shape
    kk = wide_list(k, m)
    per = -(-m // s)
    d_out = np.full((n, k), np.inf, np.float32)
    i_out = np.full((n, k), -1, np.int32)
    for r in range(n):
        lists = []
        for sp in range(s):
            lst = np.full(kk, NONE)
            for base in range(sp * per, min(m, (sp + 1) * per), chunk):
                cand = keys[r, base:min(base + chunk, (sp + 1) * per, m)]
                buf = rng.permutation(cand[cand < lst[-1]])
                if buf.size:
                    mb = 1 << int(buf.size - 1).bit_length()
                    pad = np.concatenate([buf, np.full(mb - buf.size, NONE)])
                    lst = _fold(lst, _sort(pad))
            lists.append(lst)
        order = rng.permutation(s)
        lst = lists[order[0]]
        for o in order[1:]:
            lst = _fold(lst, lists[o])
        take = min(k, kk)
        v = lst[:take]
        ok = v != NONE
        d_out[r, :take] = np.where(
            ok, (v >> np.uint64(32)).astype(np.uint32).view(np.float32),
            np.inf)
        i_out[r, :take] = np.where(ok, (v & np.uint64(0xffffffff))
                                   .astype(np.int64), -1)
    return torch.from_numpy(d_out), torch.from_numpy(i_out)


@pytest.mark.parametrize("k", [65, 100, 200])
@pytest.mark.parametrize("name", ["plain", "holes", "ragged", "count0"])
def test_wide_schedule_is_bitwise_the_plain_topk(name, k):
    x, c, mask, count = _flat_case(name, n=6, kc=600)
    m = mask & (np.arange(c.shape[0]) < count)
    want = tref.topk_ref(torch.from_numpy(x), torch.from_numpy(c), k,
                         torch.from_numpy(m))
    d2 = _plain_d2(x, c, m)
    keys = np.where(np.isfinite(d2), _keys(d2, np.arange(600)[None, :]),
                    NONE)
    rng = np.random.default_rng(k)
    for s, chunk in ((1, 600), (1, 64), (3, 128), (7, 32)):
        got = wide_emulate(keys, k, s, chunk, rng)
        assert torch.equal(got[0], want[0]), (s, chunk)
        assert torch.equal(got[1], want[1]), (s, chunk)


def test_wide_schedule_exact_ties_go_to_the_lower_id():
    x, c, mask, count = _flat_case("duplicates", n=5, kc=512)
    d2 = _plain_d2(x, c, mask)
    d2 = np.concatenate([d2[:, :256], d2[:, :256]], 1)
    keys = _keys(d2, np.arange(512)[None, :])
    got = wide_emulate(keys, 100, 4, 64, np.random.default_rng(0))
    d, i = got[0].numpy(), got[1].numpy()
    tie = d[:, 1:] == d[:, :-1]
    assert tie.any() and (i[:, 1:][tie] > i[:, :-1][tie]).all()


@pytest.mark.parametrize("m", [1, 2, 8, 64, 256])
def test_wide_bitonic_network_sorts(m):
    rng = np.random.default_rng(m)
    a = rng.integers(0, 50, size=m).astype(np.uint64)
    np.testing.assert_array_equal(_sort(a), np.sort(a))
    half = np.sort(rng.integers(0, 99, size=m).astype(np.uint64))
    other = np.sort(rng.integers(0, 99, size=m).astype(np.uint64))
    folded = _fold(half, other)
    np.testing.assert_array_equal(folded,
                                  np.sort(np.concatenate([half, other]))[:m])
    assert _WIDE_CHUNK == 2048
