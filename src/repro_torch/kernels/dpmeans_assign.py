"""Wrapper of the hand-written CUDA kernel `csrc/dpmeans_assign.cu`.

The port of the Pallas TPU kernel `repro/kernels/dpmeans_assign.py`: masked
min squared distance and argmin over a count-bounded active prefix of the
center pool. The source file says what bounds the kernel on an H100 and
what its design does about it.

The width chooses the kernel (`tile_kernel`, plain Python, mirrored by the
C dispatch): the fast tile at D = 16, the wide tile at D >= 64 with D a
multiple of 8 (its rows are then whole 16-byte pieces in every element
type), the generic tile at every other width. The center range is split
over S blocks per row block (`n_split`, a plain function of the shapes and
the SM count; `block_n` and `block_k` give a kernel's rows and centers a
tile); the result does not depend on S, nor on the kernel. The wrapper
checks every input, allocates the outputs with `torch.empty`, and launches
on PyTorch's current stream without synchronising. A split launch merges
the splits through one 64-bit key a row and one ticket counter a row block:
those live in buffers kept per (device, stream), all ones and zero, which
every launch leaves so again, so launches on one stream never share them
while they run. A launch takes its buffers and enqueues its kernel under
one process-wide lock (`_LAUNCH_LOCK`, shared with the top-k wrappers): a
thread that grows the buffers frees the old ones, and the caching allocator
may hand that memory to the next allocation on the stream, so no other
thread may hold a pointer into them that it has not enqueued yet. Threads
that launch on one stream (the default stream, unless a thread sets
another) run in the stream's order, so no launch sees another's keys or
tickets half reset. It takes CUDA tensors only: the plain version for CPU
tensors is `ref.assign_ref`, and the choice between them is made by
`ops.assign` from the tensor's device.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import DTYPE_CODES

__all__ = ["dpmeans_assign", "n_split", "block_k", "block_n", "tile_kernel",
           "BLOCK_N", "FAST_D", "WIDE_MIN_D", "WIDE_BLOCK_N"]

BLOCK_N = 64          # query rows per block of the fast and generic kernels
FAST_D = 16           # the width of the fast kernel (tiles of 256 centers)
WIDE_MIN_D = 64       # the narrowest width of the wide kernel
WIDE_BLOCK_N = 16     # query rows per block of the wide kernel
_WIDE_BK = 32         # centers per tile of the wide kernel
_BLOCKS_PER_SM = 2
_WIDE_BLOCKS_PER_SM = 4
_MIN_TILES_PER_SPLIT = 2

_SMS: dict[int, int] = {}
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_LAUNCH_LOCK = threading.Lock()   # scratch lookup through kernel enqueue


def tile_kernel(d: int) -> str:
    """The kernel that takes width d: "fast" at D = 16, "wide" at D >=
    WIDE_MIN_D with D a multiple of 8 (curation's 2048), "generic" at every
    other width (the D = 8 of the examples and `serve_clusters`, odd
    widths).  The same for every element type and alignment: the wide
    kernel stages x or centers that do not start on 16 bytes with plain
    loads instead of cp.async, to the same bits."""
    if d == FAST_D:
        return "fast"
    if d >= WIDE_MIN_D and d % 8 == 0:
        return "wide"
    return "generic"


# (query rows a block, centers a tile) of each kernel
_TILES = {"fast": (BLOCK_N, 256), "wide": (WIDE_BLOCK_N, _WIDE_BK),
          "generic": (BLOCK_N, 64)}


def block_k(d: int) -> int:
    """Centers per tile of the kernel that takes width d."""
    return _TILES[tile_kernel(d)][1]


def block_n(d: int) -> int:
    """Query rows per block of the kernel that takes width d."""
    return _TILES[tile_kernel(d)][0]


def n_split(rows: int, k: int, d: int, sms: int) -> int:
    """Blocks along the center range for `rows` query rows over a pool of
    capacity k at width d on a card of `sms` SMs.  The fast and generic
    kernels: enough that the grid holds about two blocks an SM, and at most
    one split per two tiles of the capacity, so that each split's tile ring
    has work to overlap and a pool of one or two tiles (the paper's) takes
    no merge.  The wide kernel (blocks of two warps, whose ring runs over
    the chunks of D): about four blocks an SM, at most one split a tile.
    Depends only on the shapes, never on the count or the data; the result
    does not depend on it."""
    return _split(rows, k, sms, tile_kernel(d))


def _split(rows: int, k: int, sms: int, kernel: str) -> int:
    bn, bk = _TILES[kernel]
    row_blocks = max(1, -(-rows // bn))
    tiles = max(1, -(-k // bk))
    if kernel == "wide":
        want = -(-_WIDE_BLOCKS_PER_SM * sms // row_blocks)
        return max(1, min(want, tiles))
    want = -(-_BLOCKS_PER_SM * sms // row_blocks)
    return max(1, min(want, tiles // _MIN_TILES_PER_SPLIT))


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return sms


def _scratch(dev: torch.device, stream: int, n: int):
    """(keys, tickets) of (device, stream): at least n int64 keys, all
    ones, and a ticket for each row block of the kernel with the smallest
    blocks (ceil(n/16) int32), zero."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           stream)
    got = _SCRATCH.get(key)
    if got is None or got[0].numel() < n:
        rows = max(16384, n)
        got = _SCRATCH[key] = (
            torch.full((rows,), -1, dtype=torch.int64, device=dev),
            torch.zeros((-(-rows // WIDE_BLOCK_N),), dtype=torch.int32,
                        device=dev))
    return got


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _fn():
    return _build.function("dpmeans_assign", "dpmeans_assign_fwd", _ARGTYPES)


def _check(name: str, t: torch.Tensor, dtypes, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on the CUDA device of x, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dpmeans_assign(x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor,
                   count: torch.Tensor):
    """Launch the kernel the width chooses.  x (N, D) and centers (K, D) of
    one type, float32, float16 or bfloat16; mask (K,) bool or uint8, count
    (1,) or () int32 on the device — slots at or beyond it are skipped
    without a host sync.  All on one CUDA device, contiguous.  Returns
    (d2min (N,) f32, idx (N,) int32), (inf, -1) where no valid center
    exists.  Raises on any other input (TypeError for a mix of types), and
    when the launch fails."""
    return _launch(x, centers, mask, count, generic=False)


def _generic(x: torch.Tensor, centers: torch.Tensor, mask: torch.Tensor,
             count: torch.Tensor):
    """The generic kernel at any width, on the same checks and with its own
    split: a hook for holding the wide kernel against it, bit for bit, and
    timing the two at one shape.  No path of the port calls it."""
    return _launch(x, centers, mask, count, generic=True)


def _launch(x, centers, mask, count, generic: bool):
    dev = x.device
    _check("x", x, tuple(DTYPE_CODES), 2, None)
    _check("centers", centers, (x.dtype,), 2, dev)
    _check("mask", mask, (torch.bool, torch.uint8), 1, dev)
    _check("count", count, (torch.int32,), count.dim(), dev)
    n, d = x.shape
    k = centers.shape[0]
    if centers.shape[1] != d or d == 0:
        raise ValueError(f"x {tuple(x.shape)} and centers {tuple(centers.shape)}"
                         " need one non-zero width")
    if mask.shape[0] != k or count.numel() != 1:
        raise ValueError("mask must be (K,) and count one element")
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel = tile_kernel(d)
    if generic and kernel == "wide":
        kernel = "generic"
    s = _split(n, k, _sm_count(dev), kernel)
    fn = _fn()
    with _LAUNCH_LOCK:
        keys = tickets = 0
        if s > 1 and n > 0:
            keys, tickets = (t.data_ptr() for t in _scratch(dev, stream, n))
        err = fn(x.data_ptr(), centers.data_ptr(), mask.data_ptr(),
                 count.data_ptr(), d2.data_ptr(), idx.data_ptr(), keys,
                 tickets, DTYPE_CODES[x.dtype], n, k, d, s, int(generic),
                 stream)
    if err != 0:
        raise RuntimeError(f"dpmeans_assign launch failed: CUDA error {err}")
    return d2, idx
