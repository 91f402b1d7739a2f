"""Wrapper of the hand-written CUDA kernel `csrc/flash_attention.cu`.

The port of the Pallas TPU kernel `repro/kernels/flash_attention.py`: the
causal (or full) GQA attention forward with an online softmax, f32 math,
output in q's dtype.  The source file says what bounds the kernel on an
H100 and what its design does about it.

`check_shapes` is the JAX wrapper's input contract, raised as ValueError
where that wrapper asserts; `ops.flash_attention` applies it on every
backend.  The TPU block sizes (`block_q`, `block_k`) are not taken: the
CUDA kernel's tiles are fixed.  The wrapper checks every input, allocates
the output with `torch.empty`, and launches on PyTorch's current stream
without synchronising.  It takes CUDA tensors only: the plain version for
CPU tensors is `ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (
    DTYPE_CODES, aligned16, require_cuda, require_no_grad, stream_of,
)

__all__ = ["flash_attention", "check_shapes", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)   # Dh the kernel is compiled for

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, H, S, Dh), k and v (B, Hkv, S, Dh) with H % Hkv == 0 and S a
    multiple of min(128, S), as the JAX wrapper asserts; ValueError
    otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, H, S, Dh) and k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} one "
                         "(B, Hkv, S, Dh)")
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, dh):
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}"
                         " in B, S or Dh")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} must be a multiple of Hkv={hkv}")
    if s == 0 or s % min(128, s):
        raise ValueError(f"S={s} must be a multiple of min(128, S)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None):
    """Launch the kernel.  q (B, H, S, Dh), k and v (B, Hkv, S, Dh) of one
    dtype (float32 or bfloat16) on one CUDA device, Dh in `HEAD_DIMS` and
    contiguous; any strides over (B, H, S) that keep every row 16-byte
    aligned (a transposed view of a (B, S, H, Dh) projection is taken as it
    is).  Returns a contiguous (B, H, S, Dh) tensor of q's dtype.  Raises on
    any other input, on a tensor that needs a gradient, and when the launch
    fails."""
    check_shapes(q, k, v)
    require_cuda("q", q)
    require_cuda("k", k, q.device, q.dtype)
    require_cuda("v", v, q.device, q.dtype)
    require_no_grad(q=q, k=k, v=v)
    b, h, s, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"Dh={dh} is not one of {HEAD_DIMS}")
    es = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in Dh")
        if not aligned16(t) or any(st * es % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    if scale is None:
        scale = dh ** -0.5
    o = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                DTYPE_CODES[q.dtype], b, h, k.shape[1], s, dh,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(scale), int(bool(causal)), stream_of(q))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return o
