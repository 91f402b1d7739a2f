"""Wrapper of the hand-written CUDA kernels of `csrc/rmsnorm.cu`.

The port of the Pallas TPU kernel `repro/kernels/rmsnorm.py`:
`(x * rsqrt(mean(x^2) + eps)) * w` over the last dim, f32 math, output in
x's dtype.  The source file says what bounds the kernels on an H100 and
what their designs do about it.

The row width chooses the kernel, an explicit choice made in
`one_read_packs`: the dense configurations' d_model (`ONE_READ_WIDTHS`) on
16-byte aligned rows take the one-read kernel, which holds a row in
registers between the sum of squares and the scaling; every other width
takes the two-pass kernel.  Both give the same bits.

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

__all__ = ["rmsnorm", "rmsnorm_launch", "one_read_packs",
           "ONE_READ_WIDTHS", "DTYPES"]

# The widths the one-read kernel is compiled for: the configurations'
# d_model, 2048 (granite-3-2b, internvl2-2b, olmoe-1b-7b, xlstm-1.3b), 2560
# (qwen3-4b), 3072 (phi4-mini-3.8b) and 4096 (qwen3-8b, phi3.5-moe).
ONE_READ_WIDTHS = (2048, 2560, 3072, 4096)
# The element types the kernels are compiled for.
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _fn():
    return _build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)


def one_read_packs(d: int, element_size: int, aligned: bool) -> int:
    """16-byte packs a lane holds in the one-read kernel for rows of width
    `d` (a warp of 32 lanes per row), or 0 where the two-pass kernel runs:
    a width outside `ONE_READ_WIDTHS`, or rows that are not 16-byte
    aligned."""
    if not aligned or d not in ONE_READ_WIDTHS:
        return 0
    return d * element_size // (16 * 32)


def _launch(x, weight, eps, packs, out) -> None:
    d = x.shape[-1]
    vec = d % (16 // x.element_size()) == 0 and aligned16(x, weight, out)
    err = _fn()(x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                DTYPE_CODES[x.dtype], x.numel() // d, d, float(eps), int(vec),
                packs, stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")


def _checked(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Check the inputs; return the output, allocated like x."""
    require_cuda("x", x, dtypes=DTYPES)
    require_cuda("weight", weight, x.device, x.dtype, dtypes=DTYPES)
    require_no_grad(x=x, weight=weight)
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"x must have a non-empty last dim, got {tuple(x.shape)}")
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("x and weight must be contiguous")
    return torch.empty_like(x)


def rmsnorm_launch(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> tuple[torch.Tensor, int]:
    """Launch the kernel the row width chooses and say which: returns (out,
    packs), `packs` the one-read kernel's 16-byte packs a lane, 0 when the
    two-pass kernel ran (`ops.rmsnorm` counts launches by kernel from it).
    x (..., D) contiguous, weight (D,) of x's dtype (float32, bfloat16 or
    float16), both on one CUDA device; out is a new tensor shaped and typed
    like x.
    Raises on any other input, on a tensor that needs a gradient, and when
    the launch fails."""
    out = _checked(x, weight)
    packs = one_read_packs(x.shape[-1], x.element_size(),
                           aligned16(x, weight, out))
    _launch(x, weight, eps, packs, out)
    return out, packs


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """`rmsnorm_launch`'s output alone."""
    return rmsnorm_launch(x, weight, eps)[0]


def _two_pass(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """The two-pass kernel at any width, on the same checks: a hook for
    holding it against the plain version and timing it where the wrapper
    chooses the one-read kernel.  No path of the port calls it."""
    out = _checked(x, weight)
    _launch(x, weight, eps, 0, out)
    return out
