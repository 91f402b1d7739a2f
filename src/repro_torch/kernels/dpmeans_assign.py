"""Wrapper of the hand-written CUDA kernel `csrc/dpmeans_assign.cu`.

The port of the Pallas TPU kernel `repro/kernels/dpmeans_assign.py`: masked
min squared distance and argmin over a count-bounded active prefix of the
center pool.  The source file says what bounds the kernel on an H100 and
what its design does about it.

The center range is split over S blocks per 64-row block (`n_split`, a
plain function of the shapes and the SM count); the result does not depend
on S.  The wrapper checks every input, allocates the outputs with
`torch.empty`, and launches on PyTorch's current stream without
synchronising.  A split launch merges the splits through one 64-bit key a
row and one ticket counter a row block: those live in buffers kept per
(device, stream), all ones and zero, which every launch leaves so again,
so launches on one stream never share them while they run.  A launch
takes its buffers and enqueues its kernel under one process-wide lock
(`_LAUNCH_LOCK`, shared with the top-k wrappers): a thread that grows the
buffers frees the old ones, and the caching allocator may hand that
memory to the next allocation on the stream, so no other thread may hold
a pointer into them that it has not enqueued yet.  Threads that launch
on one stream (the default stream, unless a thread sets another) run in
the stream's order, so no launch sees another's keys or tickets half
reset.  It takes CUDA
tensors only: the plain version for CPU tensors is `ref.assign_ref`, and
the choice between them is made by `ops.assign` from the tensor's device.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import DTYPE_CODES

__all__ = ["dpmeans_assign", "n_split", "block_k", "BLOCK_N", "FAST_D"]

BLOCK_N = 64          # query rows per block
FAST_D = 16           # the width of the fast kernel (tiles of 256 centers)
_BLOCKS_PER_SM = 2
_MIN_TILES_PER_SPLIT = 2

_SMS: dict[int, int] = {}
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_LAUNCH_LOCK = threading.Lock()   # scratch lookup through kernel enqueue


def block_k(d: int) -> int:
    """Centers per tile of the kernel that takes width d."""
    return 256 if d == FAST_D else 64


def n_split(rows: int, k: int, d: int, sms: int) -> int:
    """Blocks along the center range for `rows` query rows over a pool of
    capacity k at width d on a card of `sms` SMs: enough that the grid
    holds about two blocks an SM, and at most one split per two tiles of
    the capacity, so that each split's tile ring has work to overlap and a
    pool of one or two tiles (the paper's) takes no merge.  Depends only on
    the shapes, never on the count or the data; the result does not depend
    on it."""
    row_blocks = max(1, -(-rows // BLOCK_N))
    tiles = max(1, -(-k // block_k(d)))
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
    ones, and ceil(n/64) int32 tickets, zero."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           stream)
    got = _SCRATCH.get(key)
    if got is None or got[0].numel() < n:
        rows = max(16384, n)
        got = _SCRATCH[key] = (
            torch.full((rows,), -1, dtype=torch.int64, device=dev),
            torch.zeros((-(-rows // BLOCK_N),), dtype=torch.int32, device=dev))
    return got


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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
    """Launch the kernel.  x (N, D) and centers (K, D) of one type,
    float32, float16 or bfloat16; mask (K,) bool or uint8, count (1,) or ()
    int32 on the device — slots at or beyond it are skipped without a host
    sync.  All on one CUDA device, contiguous.  Returns (d2min (N,) f32,
    idx (N,) int32), (inf, -1) where no valid center exists.  Raises on any
    other input (TypeError for a mix of types), and when the launch
    fails."""
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
    s = n_split(n, k, d, _sm_count(dev))
    fn = _fn()
    with _LAUNCH_LOCK:
        keys = tickets = 0
        if s > 1 and n > 0:
            keys, tickets = (t.data_ptr() for t in _scratch(dev, stream, n))
        err = fn(x.data_ptr(), centers.data_ptr(), mask.data_ptr(),
                 count.data_ptr(), d2.data_ptr(), idx.data_ptr(), keys,
                 tickets, DTYPE_CODES[x.dtype], n, k, d, s, stream)
    if err != 0:
        raise RuntimeError(f"dpmeans_assign launch failed: CUDA error {err}")
    return d2, idx
