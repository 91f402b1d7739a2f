"""Wrapper of the hand-written CUDA kernel `csrc/rmsnorm.cu`.

The port of the Pallas TPU kernel `repro/kernels/rmsnorm.py`:
`(x * rsqrt(mean(x^2) + eps)) * w` over the last dim, f32 math, output in
x's dtype.  The source file says what bounds the kernel on an H100 and
what its design does about it.

The wrapper checks every input, allocates the output with `torch.empty`,
and launches on PyTorch's current stream without synchronising.  It takes
CUDA tensors only: the plain version for CPU tensors is `ref.rmsnorm_ref`,
and the choice between them is made by `ops.rmsnorm` from the tensor's
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (
    DTYPE_CODES, aligned16, require_cuda, require_no_grad, stream_of,
)

__all__ = ["rmsnorm"]

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """Launch the kernel.  x (..., D) contiguous, weight (D,) of x's dtype
    (float32 or bfloat16), both on one CUDA device.  Returns a new tensor
    shaped and typed like x.  Raises on any other input, on a tensor that
    needs a gradient, and when the launch fails."""
    require_cuda("x", x)
    require_cuda("weight", weight, x.device, x.dtype)
    require_no_grad(x=x, weight=weight)
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"x must have a non-empty last dim, got {tuple(x.shape)}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("x and weight must be contiguous")
    out = torch.empty_like(x)
    pack = 16 // x.element_size()
    vec = d % pack == 0 and aligned16(x, weight, out)
    err = _fn()(x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                DTYPE_CODES[x.dtype], x.numel() // d, d, float(eps), int(vec),
                stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
    return out
