"""Wrapper of the hand-written CUDA kernels of `csrc/rmsnorm.cu`.

The port of the Pallas TPU kernel `repro/kernels/rmsnorm.py`:
`(x * rsqrt(mean(x^2) + eps)) * w` over the last dim, f32 math, output in
x's dtype, and its backward (`rmsnorm_bwd`: dx and dw from x, w and the
output gradient, the kernel `ops.rmsnorm`'s autograd Function launches).
The source file says what bounds the kernels on an H100 and what their
designs do about it.

The row width chooses the kernel, an explicit choice made in
`one_read_packs`: the dense configurations' d_model (`ONE_READ_WIDTHS`) on
16-byte aligned rows take the one-read kernel, which holds a row in
registers between the sum of squares and the scaling; every other width
takes the two-pass kernel.  Both give the same bits.  The backward chooses
the same way (`bwd_one_read_threads`): at those widths a block of d / 8
threads a row on a constant grid of `BWD_ONE_READ_BLOCKS` blocks
(`bwd_one_read_blocks`, each owning the rows `bwd_rows_of` gives it), else
the two-sweep kernel (`bwd_warps`, `bwd_blocks`).

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
           "ONE_READ_WIDTHS", "DTYPES", "rmsnorm_bwd", "bwd_warps",
           "bwd_blocks", "BWD_MAX_BLOCKS", "BWD_SMEM_BYTES", "BWD_ROW_ALIGN",
           "bwd_one_read_threads", "bwd_one_read_blocks", "bwd_rows_of",
           "BWD_ONE_READ_BLOCKS", "BWD_COLS"]

# The widths the one-read kernel is compiled for: the configurations'
# d_model, 1024 (seamless-m4t-medium), 2048 (granite-3-2b, internvl2-2b,
# olmoe-1b-7b, xlstm-1.3b), 2560 (qwen3-4b), 3072 (phi4-mini-3.8b), 3584
# (zamba2-7b) and 4096 (qwen3-8b, phi3.5-moe).
ONE_READ_WIDTHS = (1024, 2048, 2560, 3072, 3584, 4096)
# The element types the kernels are compiled for.
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ONE_READ_ARGTYPES = [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p]

# The one-read backward's grid: this many blocks (fewer only for fewer
# rows), block b taking rows b, b + 264, ...  A constant, not the card's SM
# count, so the dw partials and their order are the same on every card:
# two blocks an SM of the H100's 132, all resident at once at the dense
# widths (a block is at most 512 threads of 64 registers and 64 KB of
# shared memory).
BWD_ONE_READ_BLOCKS = 264
# Columns a thread of the one-read backward owns: one 16-byte pack of bf16
# or f16, two of f32.
BWD_COLS = 8

# The two-sweep backward's grid: at most this many blocks, each owning a
# fixed range of rows (a constant, not the card's SM count, so the dw
# partials and their order are the same on every card): about four blocks
# an SM on the H100.
BWD_MAX_BLOCKS = 512
# Shared memory a block of the backward may take (the H100's 227 KB): one
# f32 row per warp, of width d rounded up to BWD_ROW_ALIGN (32 packs of 16
# bytes in the narrowest type).
BWD_SMEM_BYTES = 232_448
BWD_ROW_ALIGN = 256


def _fn():
    return _build.function("rmsnorm", "rmsnorm_fwd", _ARGTYPES)


def _bwd_fn():
    return _build.function("rmsnorm", "rmsnorm_bwd", _BWD_ARGTYPES)


def _bwd_one_read_fn():
    return _build.function("rmsnorm", "rmsnorm_bwd_one_read",
                           _BWD_ONE_READ_ARGTYPES)


def one_read_packs(d: int, element_size: int, aligned: bool) -> int:
    """16-byte packs a lane holds in the one-read kernel for rows of width
    `d` (a warp of 32 lanes per row), or 0 where the two-pass kernel runs:
    a width outside `ONE_READ_WIDTHS`, or rows that are not 16-byte
    aligned."""
    if not aligned or d not in ONE_READ_WIDTHS:
        return 0
    return d * element_size // (16 * 32)


def bwd_one_read_threads(d: int, aligned: bool) -> int:
    """Threads a block of the one-read backward for rows of width `d` (d /
    BWD_COLS, one row at a time, each thread owning BWD_COLS columns), or 0
    where the two-sweep kernel runs: a width outside `ONE_READ_WIDTHS`, or
    x, dy, w and dx not all 16-byte aligned.  The same for every element
    type."""
    if not aligned or d not in ONE_READ_WIDTHS:
        return 0
    return d // BWD_COLS


def bwd_one_read_blocks(rows: int) -> int:
    """Blocks of the one-read backward for `rows` rows: BWD_ONE_READ_BLOCKS,
    or one a row when there are fewer."""
    return max(1, min(BWD_ONE_READ_BLOCKS, rows))


def bwd_rows_of(block: int, rows: int, blocks: int) -> range:
    """The rows block `block` of the one-read backward owns, as the kernel
    walks them: block, block + blocks, ... below rows (the grid's rows in
    flight lie side by side in memory).  With blocks <= rows every block
    owns at least one row."""
    return range(block, rows, blocks)


def bwd_warps(d: int) -> int:
    """Warps a block of the two-sweep backward kernel: 4, or as many f32
    rows of width d (rounded up to BWD_ROW_ALIGN) as the block's shared
    memory holds.
    Raises ValueError for a row too wide for one (d > 58,112)."""
    warps = min(4, BWD_SMEM_BYTES // (4 * (-(-d // BWD_ROW_ALIGN)
                                           * BWD_ROW_ALIGN)))
    if warps < 1:
        raise ValueError(f"rmsnorm backward takes rows up to "
                         f"{BWD_SMEM_BYTES // 4} wide, got {d}")
    return warps


def bwd_blocks(rows: int, warps: int) -> int:
    """Blocks of the two-sweep backward kernel for `rows` rows: one a
    warp's row up to BWD_MAX_BLOCKS; each owns ceil(rows / blocks)
    consecutive rows."""
    return max(1, min(BWD_MAX_BLOCKS, -(-rows // warps)))


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


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel the row width chooses: (dx, dw) for the
    output gradient `dy`, dx shaped and typed like x, dw like weight;
    deterministic (no float atomics).  x and dy (..., D) contiguous of one
    shape, weight (D,), one dtype (float32, bfloat16 or float16), one CUDA
    device.  Raises on any other input, on a tensor that needs a gradient
    (`ops.rmsnorm`'s autograd Function calls this from its backward, where
    none does), and when the launch fails."""
    return _bwd(x, weight, dy, eps, one_read=True)


def _two_sweep(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
               eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-sweep backward at any width, on the same checks: a hook for
    holding it against the one-read kernel and timing it at the dense
    widths.  No path of the port calls it."""
    return _bwd(x, weight, dy, eps, one_read=False)


def _bwd(x, weight, dy, eps, one_read: bool):
    dx = _checked(x, weight)
    require_cuda("dy", dy, x.device, x.dtype, dtypes=DTYPES)
    require_no_grad(dy=dy)
    if dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f"dy must be contiguous and shaped like x "
                         f"{tuple(x.shape)}, got {tuple(dy.shape)}")
    d = x.shape[-1]
    rows = x.numel() // d
    dw = torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_()
    aligned = aligned16(x, weight, dy, dx)
    threads = bwd_one_read_threads(d, aligned) if one_read else 0
    code = DTYPE_CODES[x.dtype]
    if threads:
        blocks = bwd_one_read_blocks(rows)
        partial = torch.empty((blocks, d), dtype=torch.float32,
                              device=x.device)
        err = _bwd_one_read_fn()(
            x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), code, rows, d, float(eps),
            blocks, stream_of(x))
    else:
        warps = bwd_warps(d)
        blocks = bwd_blocks(rows, warps)
        partial = torch.empty((blocks, d), dtype=torch.float32,
                              device=x.device)
        vec = d % (16 // x.element_size()) == 0 and aligned
        err = _bwd_fn()(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                        dx.data_ptr(), dw.data_ptr(), partial.data_ptr(),
                        code, rows, d, float(eps), int(vec), warps, blocks,
                        stream_of(x))
    if err != 0:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error {err}")
    return dx, dw
