"""Wrapper of the hand-written CUDA kernel `csrc/dpmeans_assign.cu`.

The port of the Pallas TPU kernel `repro/kernels/dpmeans_assign.py`: masked
min squared distance and argmin over a count-bounded active prefix of the
center pool.  The source file says what bounds the kernel on an H100 and
what its design does about it.

The wrapper checks every input, allocates the outputs with `torch.empty`,
and launches on PyTorch's current stream without synchronising.  It takes
CUDA tensors only: the plain version for CPU tensors is `ref.assign_ref`,
and the choice between them is made by `ops.assign` from the tensor's
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["dpmeans_assign"]

_FN = None


def _fn():
    global _FN
    if _FN is None:
        lib = _build.load("dpmeans_assign")
        fn = lib.dpmeans_assign_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    """Launch the kernel.  x (N, D) f32, centers (K, D) f32, mask (K,) bool
    or uint8, count (1,) or () int32 on the device — slots at or beyond it
    are skipped without a host sync.  All on one CUDA device, contiguous.
    Returns (d2min (N,) f32, idx (N,) int32), (inf, -1) where no valid
    center exists.  Raises on any other input, and when the launch fails."""
    dev = x.device
    _check("x", x, (torch.float32,), 2, None)
    _check("centers", centers, (torch.float32,), 2, dev)
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
    err = _fn()(x.data_ptr(), centers.data_ptr(), mask.data_ptr(),
                count.data_ptr(), d2.data_ptr(), idx.data_ptr(), n, k, d, stream)
    if err != 0:
        raise RuntimeError(f"dpmeans_assign launch failed: CUDA error {err}")
    return d2, idx
