"""Wrapper of the hand-written CUDA kernel `csrc/swiglu.cu`.

The port of the Pallas TPU kernel `repro/kernels/swiglu.py`:
`silu(gate) * up` elementwise, f32 math, output in gate's dtype, and its
backward (`swiglu_bwd`, the kernel `ops.swiglu`'s autograd Function
launches).  The source file says what bounds the kernel on an H100 and what its design
does about it.

The wrapper checks every input, allocates the output with `torch.empty`,
and launches on PyTorch's current stream without synchronising.  It takes
CUDA tensors only: the plain version for CPU tensors is `ref.swiglu_ref`,
and the choice between them is made by `ops.swiglu` from the tensor's
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (
    DTYPE_CODES, aligned16, require_cuda, require_no_grad, stream_of,
)

__all__ = ["swiglu", "swiglu_bwd"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _fn():
    return _build.function("swiglu", "swiglu_fwd", _ARGTYPES)


def _checked(gate: torch.Tensor, up: torch.Tensor, **more) -> None:
    require_cuda("gate", gate)
    require_cuda("up", up, gate.device, gate.dtype)
    for name, t in more.items():
        require_cuda(name, t, gate.device, gate.dtype)
    require_no_grad(gate=gate, up=up, **more)
    for name, t in (("up", up), *more.items()):
        if t.shape != gate.shape:
            raise ValueError(f"gate {tuple(gate.shape)} and {name} "
                             f"{tuple(t.shape)} must have one shape")
    if not all(t.is_contiguous() for t in (gate, up, *more.values())):
        raise ValueError("the inputs must be contiguous")


def swiglu(gate: torch.Tensor, up: torch.Tensor):
    """Launch the kernel.  gate and up of one shape and dtype (float32 or
    bfloat16), contiguous, on one CUDA device.  Returns a new tensor shaped
    and typed like gate.  Raises on any other input, on a tensor that needs
    a gradient, and when the launch fails."""
    _checked(gate, up)
    out = torch.empty_like(gate)
    err = _fn()(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                DTYPE_CODES[gate.dtype], gate.numel(),
                int(aligned16(gate, up, out)), stream_of(gate))
    if err != 0:
        raise RuntimeError(f"swiglu launch failed: CUDA error {err}")
    return out


def swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, dy: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (dgate, dup) for the output gradient
    `dy`, each shaped and typed like gate.  gate, up and dy of one shape
    and dtype (float32 or bfloat16), contiguous, on one CUDA device.
    Raises on any other input, on a tensor that needs a gradient, and when
    the launch fails."""
    _checked(gate, up, dy=dy)
    dgate, dup = torch.empty_like(gate), torch.empty_like(gate)
    err = _build.function("swiglu", "swiglu_bwd", _BWD_ARGTYPES)(
        gate.data_ptr(), up.data_ptr(), dy.data_ptr(), dgate.data_ptr(),
        dup.data_ptr(), DTYPE_CODES[gate.dtype], gate.numel(),
        int(aligned16(gate, up, dy, dgate, dup)), stream_of(gate))
    if err != 0:
        raise RuntimeError(f"swiglu backward launch failed: CUDA error {err}")
    return dgate, dup
