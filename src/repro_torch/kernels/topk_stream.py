"""Wrappers of the hand-written CUDA kernels `csrc/topk_stream.cu`.

The port of the Pallas TPU kernels `repro/kernels/topk_stream.py`: the k
nearest centers per query row, by the lexicographic (d², id) selection of
`ref.topk_merge_ref`, over a count-bounded flat center prefix
(`topk_stream`) or over the probed fine shards of a two-level index
(`topk_multiprobe_stream`).  The source file says what bounds the kernels
on an H100 and what their design does about it.

One launch a call.  For k <= 64 (`MAX_K`) the candidate range is split
over S blocks per 64-row block (`n_split`, `mp_n_split`, `block_k`: plain
functions of the shapes and the SM count); the result does not depend on
S.  A split flat
launch merges in the same launch through per-split lists and tickets, a
multi-probe launch through per-pair lists, a count a row and tickets;
these live per (device, stream), and every launch leaves counts and
tickets reset, so nothing is allocated a call but the outputs.  A launch
takes its scratch and enqueues its kernel under `dpmeans_assign`'s
launch lock (the reason is given there).  A k above 64 takes the wide
route of the same source (`topk_wide_f32` / `topk_mp_wide_f32`): one
block a (query row, split), its list in shared memory or, past 2,048
keys, in global scratch allocated by the call, the splits merged in the
same launch through a ticket a row (`wide_n_split`, `wide_list`).  The
wrappers check every input and launch on PyTorch's current stream of the
input's device without synchronising.  They take float32 CUDA tensors
only: the plain versions for CPU tensors are `ref.topk_ref` and
`ref.topk_multiprobe_ref`, and the choice between them is made by
`ops.serve_topk` / `ops.serve_topk_multiprobe` from the tensor's device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dpmeans_assign import _LAUNCH_LOCK, _check, _sm_count
from repro_torch.kernels.dpmeans_assign import n_split as _assign_n_split

__all__ = ["topk_stream", "topk_multiprobe_stream", "topk_tile_loads",
           "n_split", "mp_n_split", "block_k", "wide_n_split", "wide_list",
           "MAX_K", "BLOCK_K"]

MAX_K = 64        # the largest k of the register-list kernels
BLOCK_K = 64      # the tile width the serving plane counts skipped tiles in
FAST_D = 16       # the width of the fast tile
_FAST_BK = 256    # centers per fast tile
_GENERIC_BK = 64  # centers per generic tile
_FAST_TILES_PER_SPLIT = 4
_BLOCK_N = 64     # query rows per block
_TICKETS = 32     # tickets a row block (the kernels' TICKETS_PER_BLOCK)
_BLOCKS_PER_SM = 2
_WIDE_CHUNK = 2048      # candidates a round of the wide route (wide::CHUNK)
_WIDE_LIST_SMEM = 2048  # its lists up to this length live in shared memory

_SCRATCH: dict[tuple[int, int], dict[str, torch.Tensor]] = {}


# The C entry points' argument types: pointers, ints, the stream.
_ARGTYPES = {name: [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
             + [ctypes.c_void_p]
             for name, n_ptr in (("topk_stream_f32", 10),
                                 ("topk_multiprobe_f32", 14))}
_ARGTYPES["topk_wide_f32"] = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                              + [ctypes.c_void_p])
_ARGTYPES["topk_mp_wide_f32"] = ([ctypes.c_void_p] * 12
                                 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _fn(name: str):
    return _build.function("topk_stream", name, _ARGTYPES[name])


def block_k(rows: int, k: int, d: int, sms: int) -> int:
    """Centers per tile of the flat kernel for k > 1: the nearest-center
    kernel's fast tile of 256 at D = 16 where its rule splits the capacity
    (`dpmeans_assign.n_split` > 1), else the generic tile of 64, so that a
    pool of one or two fast tiles (the multi-probe routing) still runs on
    several blocks."""
    if d == FAST_D and _assign_n_split(rows, k, d, sms) > 1:
        return _FAST_BK
    return _GENERIC_BK


def n_split(rows: int, k: int, d: int, sms: int) -> int:
    """Blocks along the center range of the flat kernel for k > 1: about
    two blocks an SM, at most one split per four fast tiles (a split's
    first tile pays for filling its lists, so fewer, longer splits win up
    to there) or per generic tile.  Depends only on the shapes, never on
    the count or the data; the result does not depend on it.  (At k = 1
    the flat call is the nearest-center kernel, with its own rule.)"""
    row_blocks = max(1, -(-rows // _BLOCK_N))
    want = -(-_BLOCKS_PER_SM * sms // row_blocks)
    if block_k(rows, k, d, sms) == _FAST_BK:
        return max(1, min(want, -(-k // _FAST_BK) // _FAST_TILES_PER_SPLIT))
    return max(1, min(want, -(-k // _GENERIC_BK)))


def mp_n_split(rows: int, u: int, sms: int) -> int:
    """Blocks along the union ranks of the multi-probe kernel for `rows`
    queries over a union of capacity u: about two blocks an SM, at most
    one a rank.  Depends only on the shapes, never on u_count or the
    data."""
    row_blocks = max(1, -(-rows // _BLOCK_N))
    want = -(-_BLOCKS_PER_SM * sms // row_blocks)
    return max(1, min(want, u))


def wide_n_split(rows: int, cands: int, sms: int) -> int:
    """Blocks along the candidate range of the wide route (k > 64) for
    `rows` query rows over `cands` candidates (the capacity, or U * S_cap
    for multi-probe, whose splits take union ranks and so are at most U):
    about two blocks an SM, at most one split per four rounds of
    candidates.  Depends only on the shapes; the result does not depend on
    it."""
    want = -(-_BLOCKS_PER_SM * sms // max(1, rows))
    return max(1, min(want, -(-cands // (4 * _WIDE_CHUNK))))


def wide_list(k: int, cands: int) -> int:
    """The wide route's list length: the power of two at or above
    min(k, cands) (at least 1); columns past it come back (inf, -1)."""
    return _next_pow2(max(1, min(k, cands)))


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _groups(s: int) -> int:
    """Groups of the flat kernel's merge tree for s splits (the kernel's
    `group_size`: all s up to 16, else about sqrt(s) a group)."""
    if s <= 16:
        return 1
    gs = math.isqrt(s - 1) + 1
    return -(-s // gs)


def _scratch(dev: torch.device, stream: int, n: int, entries: int):
    """The merges' scratch of (device, stream): n int64 keys, all ones (the
    k = 1 merge); n int32 list counts, zero; 32 int32 tickets a row block,
    zero; and lists of `entries` entries (f32 and int32)."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           stream)
    got = _SCRATCH.get(key)
    if (got is None or got["keys"].numel() < n
            or got["part_d"].numel() < entries):
        rows = max(4096, n, 0 if got is None else got["keys"].numel())
        size = max(entries, 1 << 20,
                   0 if got is None else got["part_d"].numel())
        got = _SCRATCH[key] = {
            "keys": torch.full((rows,), -1, dtype=torch.int64, device=dev),
            "counts": torch.zeros((rows,), dtype=torch.int32, device=dev),
            "part_d": torch.empty((size,), dtype=torch.float32, device=dev),
            "part_i": torch.empty((size,), dtype=torch.int32, device=dev),
            "tickets": torch.zeros((_TICKETS * -(-rows // _BLOCK_N),),
                                   dtype=torch.int32, device=dev)}
    return got


def topk_tile_loads(count: int, k_total: int, block_k: int = 128) -> int:
    """Center tiles one row-block sweep of the flat kernel loads, the
    count of `repro.kernels.topk_stream.topk_tile_loads` in closed form:
    the clamped index map min(j, last active tile) changes value once per
    tile up to the last active one, so the loads are max(1, ceil(count/bk))
    capped at the tile count.  Tiles past the active prefix load nothing,
    which is what the CUDA kernels' count-bounded loop does too."""
    bk = min(block_k, max(8, k_total))
    k_tiles = -(-k_total // bk)
    return min(max(-(-count // bk), 1), k_tiles)


def _bucket(k: int) -> int:
    """The power of two at or above k: a register-list bucket up to
    `MAX_K`, above it the wide route."""
    if k < 1:
        raise ValueError(f"k={k}: the top-k kernels take k >= 1")
    return _next_pow2(k)


def _wide_part(dev, n: int, s: int, kk: int):
    """The wide route's list scratch (n * s * kk keys), or None when
    every list stays in shared memory."""
    if s == 1 and kk <= _WIDE_LIST_SMEM:
        return None
    return torch.empty((n * s * kk,), dtype=torch.int64, device=dev)


def topk_stream(x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor, k: int):
    """Launch the flat kernel.  x (N, D) f32, centers (K, D) f32, mask (K,)
    bool or uint8, count (1,) or () int32 on the device — slots at or
    beyond it are skipped without a host sync — and k >= 1 (above 64 the
    wide route).  Returns (d2 (N, k) f32 ascending, idx (N, k) int32),
    (inf, -1) in exhausted slots.  Raises on any other input, and when the
    launch fails."""
    dev = x.device
    _check("x", x, (torch.float32,), 2, None)
    _check("centers", centers, (torch.float32,), 2, dev)
    _check("mask", mask, (torch.bool, torch.uint8), 1, dev)
    _check("count", count, (torch.int32,), count.dim(), dev)
    n, d = x.shape
    kc = centers.shape[0]
    if centers.shape[1] != d or d == 0:
        raise ValueError(f"x {tuple(x.shape)} and centers "
                         f"{tuple(centers.shape)} need one non-zero width")
    if mask.shape[0] != kc or count.numel() != 1:
        raise ValueError("mask must be (K,) and count one element")
    kk = _bucket(int(k))
    sms = _sm_count(dev)
    if kk > MAX_K:
        return _wide_flat(x, centers, mask, count, int(k), sms)
    if kk == 1:   # the nearest-center kernel: its own tiles and split rule
        bk, s = 0, _assign_n_split(n, kc, d, sms)
    else:
        bk, s = block_k(n, kc, d, sms), n_split(n, kc, d, sms)
    d2 = torch.empty((n, int(k)), dtype=torch.float32, device=dev)
    idx = torch.empty((n, int(k)), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _fn("topk_stream_f32")
    with _LAUNCH_LOCK:
        ptrs = [0] * 4
        if s > 1 and n > 0:
            g = _scratch(dev, stream, n, n * (s + _groups(s)) * kk)
            ptrs = [g[name].data_ptr() for name in
                    ("keys", "part_d", "part_i", "tickets")]
        err = fn(x.data_ptr(), centers.data_ptr(), mask.data_ptr(),
                 count.data_ptr(), d2.data_ptr(), idx.data_ptr(), *ptrs, n,
                 kc, d, kk, int(k), bk, s, stream)
    if err != 0:
        raise RuntimeError(f"topk_stream launch failed: CUDA error {err}")
    return d2, idx


def topk_multiprobe_stream(x: torch.Tensor, fine: torch.Tensor,
                           fine_ids: torch.Tensor, fine_mask: torch.Tensor,
                           cells: torch.Tensor, member: torch.Tensor,
                           u_count: torch.Tensor, k: int,
                           _stats: torch.Tensor | None = None):
    """Launch the multi-probe kernel.  x (B, D) f32; fine (n_cells, S, D)
    f32, fine_ids (n_cells, S) int32 flat ids, fine_mask (n_cells, S) bool;
    cells (U,) int32, the probed-cell union packed ascending with -1
    padding; member (B, U) bool, query b may see cell cells[u]; u_count
    (1,) or () int32 on the device, the union's real length (ranks at or
    past it are skipped without a host sync); k >= 1 (above 64 the wide
    route).  Returns (d2 (B, k) f32, idx (B, k) int32 flat ids), (inf, -1)
    in exhausted slots.  `_stats`, a private hook for checks on the card:
    an int64 tensor of two counters the kernel adds to (distances formed;
    pair lists appended; the wide route adds to the first only)."""
    dev = x.device
    _check("x", x, (torch.float32,), 2, None)
    _check("fine", fine, (torch.float32,), 3, dev)
    _check("fine_ids", fine_ids, (torch.int32,), 2, dev)
    _check("fine_mask", fine_mask, (torch.bool, torch.uint8), 2, dev)
    _check("cells", cells, (torch.int32,), 1, dev)
    _check("member", member, (torch.bool, torch.uint8), 2, dev)
    _check("u_count", u_count, (torch.int32,), u_count.dim(), dev)
    b, d = x.shape
    n_cells, s_cap, fd = fine.shape
    u = cells.shape[0]
    if fd != d or d == 0:
        raise ValueError(f"x {tuple(x.shape)} and fine {tuple(fine.shape)} "
                         "need one non-zero width")
    if (tuple(fine_ids.shape) != (n_cells, s_cap)
            or tuple(fine_mask.shape) != (n_cells, s_cap)):
        raise ValueError("fine_ids and fine_mask must be (n_cells, S)")
    if tuple(member.shape) != (b, u) or u_count.numel() != 1:
        raise ValueError("member must be (B, U) and u_count one element")
    kk = _bucket(int(k))
    d2 = torch.empty((b, int(k)), dtype=torch.float32, device=dev)
    idx = torch.empty((b, int(k)), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    stats = 0
    if _stats is not None:
        _check("_stats", _stats, (torch.int64,), 1, dev)
        if _stats.numel() < 2:
            raise ValueError("_stats needs two counters")
        stats = _stats.data_ptr()
    if kk > MAX_K:
        kl = wide_list(int(k), u * s_cap)
        s = max(1, min(wide_n_split(b, u * s_cap, _sm_count(dev)), u))
        fn = _fn("topk_mp_wide_f32")
        with _LAUNCH_LOCK:
            part = tickets = 0
            if b > 0:
                tickets = _scratch(dev, stream, b, 0)["counts"].data_ptr()
                p = _wide_part(dev, b, s, kl)
                part = 0 if p is None else p.data_ptr()
            err = fn(x.data_ptr(), fine.data_ptr(), fine_ids.data_ptr(),
                     fine_mask.data_ptr(), cells.data_ptr(),
                     member.data_ptr(), u_count.data_ptr(), d2.data_ptr(),
                     idx.data_ptr(), part, tickets, stats, b, u, s_cap, d,
                     kl, int(k), s, stream)
        if err != 0:
            raise RuntimeError(
                f"topk_multiprobe_stream launch failed: CUDA error {err}")
        return d2, idx
    s = mp_n_split(b, u, _sm_count(dev))
    fn = _fn("topk_multiprobe_f32")
    with _LAUNCH_LOCK:
        ptrs = [0] * 4
        if b > 0:
            g = _scratch(dev, stream, b, b * u * kk)
            ptrs = [g[name].data_ptr() for name in
                    ("part_d", "part_i", "counts", "tickets")]
        err = fn(x.data_ptr(), fine.data_ptr(), fine_ids.data_ptr(),
                 fine_mask.data_ptr(), cells.data_ptr(), member.data_ptr(),
                 u_count.data_ptr(), d2.data_ptr(), idx.data_ptr(), *ptrs,
                 stats, b, u, s_cap, d, kk, int(k), s, stream)
    if err != 0:
        raise RuntimeError(
            f"topk_multiprobe_stream launch failed: CUDA error {err}")
    return d2, idx


def _wide_flat(x, centers, mask, count, k: int, sms: int):
    """The flat wide route (k > 64); inputs already checked."""
    dev = x.device
    n, d = x.shape
    kc = centers.shape[0]
    kl = wide_list(k, kc)
    s = wide_n_split(n, kc, sms)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _fn("topk_wide_f32")
    with _LAUNCH_LOCK:
        part = tickets = 0
        if n > 0:
            tickets = _scratch(dev, stream, n, 0)["counts"].data_ptr()
            p = _wide_part(dev, n, s, kl)
            part = 0 if p is None else p.data_ptr()
        err = fn(x.data_ptr(), centers.data_ptr(), mask.data_ptr(),
                 count.data_ptr(), d2.data_ptr(), idx.data_ptr(), part,
                 tickets, n, kc, d, kl, k, s, stream)
    if err != 0:
        raise RuntimeError(f"topk_stream launch failed: CUDA error {err}")
    return d2, idx
