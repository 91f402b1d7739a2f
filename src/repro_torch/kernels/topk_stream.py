"""Wrappers of the hand-written CUDA kernels `csrc/topk_stream.cu`.

The port of the Pallas TPU kernels `repro/kernels/topk_stream.py`: the k
nearest centers per query row, by the lexicographic (d², id) selection of
`ref.topk_merge_ref`, over a count-bounded flat center prefix
(`topk_stream`) or over the probed fine shards of a two-level index
(`topk_multiprobe_stream`).  The source file says what bounds the kernels
on an H100 and what their design does about it.

The wrappers check every input, allocate the outputs and the per-split
scratch with `torch.empty`, and launch on PyTorch's current stream of the
input's device without synchronising.  They take CUDA tensors only: the
plain versions for CPU tensors are `ref.topk_ref` and
`ref.topk_multiprobe_ref`, and the choice between them is made by
`ops.serve_topk` / `ops.serve_topk_multiprobe` from the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dpmeans_assign import _check

__all__ = ["topk_stream", "topk_multiprobe_stream", "topk_tile_loads",
           "MAX_K", "BLOCK_K"]

MAX_K = 64        # the largest k bucket the kernels are compiled for
BLOCK_K = 64      # centers per tile of the CUDA kernels
_BLOCK_N = 64     # query rows per block
_BLOCKS_PER_SM = 2

_FNS: dict[str, object] = {}


def _fn(name: str, n_ptr: int, n_int: int):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("topk_stream"), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the top-k kernels take 1 <= k <= {MAX_K}")
    b = 1
    while b < k:
        b <<= 1
    return b


_SMS: dict[int, int] = {}


def _n_split(dev: torch.device, rows: int, items: int) -> int:
    """Blocks along the candidate range: enough that the grid fills the
    card about twice, at most one per candidate tile.  Depends only on the
    shapes, never on the data; the result does not depend on it."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    row_blocks = -(-rows // _BLOCK_N)
    want = -(-_BLOCKS_PER_SM * sms // row_blocks)
    return max(1, min(want, items))


def _outputs(n: int, kk: int, k: int, n_split: int, dev):
    part_d = torch.empty((n_split, n, kk), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, n, kk), dtype=torch.int32, device=dev)
    d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    return part_d, part_i, d2, idx


def topk_stream(x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor, k: int):
    """Launch the flat kernel.  x (N, D) f32, centers (K, D) f32, mask (K,)
    bool or uint8, count (1,) or () int32 on the device — slots at or
    beyond it are skipped without a host sync — and 1 <= k <= 64.  Returns
    (d2 (N, k) f32 ascending, idx (N, k) int32), (inf, -1) in exhausted
    slots.  Raises on any other input, and when the launch fails."""
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
    n_split = _n_split(dev, n, max(1, -(-kc // BLOCK_K)))
    part_d, part_i, d2, idx = _outputs(n, kk, int(k), n_split, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("topk_stream_f32", 8, 6)(
        x.data_ptr(), centers.data_ptr(), mask.data_ptr(), count.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        n, kc, d, kk, int(k), n_split, stream)
    if err != 0:
        raise RuntimeError(f"topk_stream launch failed: CUDA error {err}")
    return d2, idx


def topk_multiprobe_stream(x: torch.Tensor, fine: torch.Tensor,
                           fine_ids: torch.Tensor, fine_mask: torch.Tensor,
                           cells: torch.Tensor, member: torch.Tensor,
                           u_count: torch.Tensor, k: int):
    """Launch the multi-probe kernel.  x (B, D) f32; fine (n_cells, S, D)
    f32, fine_ids (n_cells, S) int32 flat ids, fine_mask (n_cells, S) bool;
    cells (U,) int32, the probed-cell union packed ascending with -1
    padding; member (B, U) bool, query b may see cell cells[u]; u_count
    (1,) or () int32 on the device, the union's real length (ranks at or
    past it are skipped without a host sync); 1 <= k <= 64.  Returns
    (d2 (B, k) f32, idx (B, k) int32 flat ids), (inf, -1) in exhausted
    slots."""
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
    n_split = _n_split(dev, b, max(1, u * -(-s_cap // BLOCK_K)))
    part_d, part_i, d2, idx = _outputs(b, kk, int(k), n_split, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("topk_multiprobe_f32", 11, 7)(
        x.data_ptr(), fine.data_ptr(), fine_ids.data_ptr(),
        fine_mask.data_ptr(), cells.data_ptr(), member.data_ptr(),
        u_count.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
        d2.data_ptr(), idx.data_ptr(), b, u, s_cap, d, kk, int(k), n_split,
        stream)
    if err != 0:
        raise RuntimeError(
            f"topk_multiprobe_stream launch failed: CUDA error {err}")
    return d2, idx
