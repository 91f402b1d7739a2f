"""Wrapper of the hand-written CUDA kernels of `csrc/flash_attention.cu`.

The port of the Pallas TPU kernel `repro/kernels/flash_attention.py`: the
causal (or full) GQA attention forward with an online softmax, f32
statistics and accumulators, output in q's dtype.  The source file says
what bounds the kernels on an H100 and what their designs do about it.

The element type chooses the kernel, an explicit dispatch in
`flash_attention`:

  bfloat16  the tensor-core kernel: both products on wgmma, K/V tiles fed
            by TMA (its tiles for each Dh are compiled into the source;
            `tma_geometry` gives the tensor maps' extents and byte
            strides);
  float32   the FMA kernel, the IEEE parity tier (f32 math throughout).

A bf16 CUDA tensor always launches the tensor-core kernel: nothing falls
back to the FMA kernel or to the plain version, and a failed build, tensor
map or launch raises.

`check_shapes` is the JAX wrapper's input contract, raised as ValueError
where that wrapper asserts; `ops.flash_attention` applies it on every
backend.  The TPU block sizes (`block_q`, `block_k`) are not taken: the
CUDA kernels' tiles are fixed.  The wrapper checks every input, allocates
the output with `torch.empty`, and launches on PyTorch's current stream
without synchronising.  It takes CUDA tensors only: the plain version for
CPU tensors is `ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (
    require_cuda, require_no_grad, stream_of,
)

__all__ = ["flash_attention", "check_shapes", "HEAD_DIMS", "tma_geometry"]

# Dh the kernels are compiled for (112, zamba2-7b's, runs the Dh-128 tile
# of the tensor-core kernel with TMA zero-filling columns 112-127)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
# The driver's codes for a failed cuTensorMapEncodeTiled start here.
_ENCODE_ERROR = 100000


def _check_rows(name: str, t: torch.Tensor) -> None:
    es = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"{name} must be contiguous in Dh")
    if t.data_ptr() % 16 or any(st * es % 16 for st in t.stride()[:3]):
        raise ValueError(f"{name}'s rows must be 16-byte aligned")


def tma_geometry(name: str, t: torch.Tensor) -> tuple[int, ...]:
    """The seven values of a tensor map over the 4-D view (Dh, S, H, B) of
    a (B, H, S, Dh) tensor: the extents Dh, S, H, B and the byte strides of
    S, H and B, read from `t.stride()` (a transposed view of a (B, S, H, Dh)
    projection is taken as it is).  ValueError for a view TMA cannot read:
    Dh not contiguous, or a base or a stride that is not a multiple of 16
    bytes."""
    _check_rows(name, t)
    b, h, s, dh = t.shape
    es = t.element_size()
    return (dh, s, h, b, t.stride(2) * es, t.stride(1) * es, t.stride(0) * es)


# The C entry points' argument types, by name.
_ARGTYPES = {
    "flash_attention_f32_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_void_p],
    "flash_attention_bf16_fwd": [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]}


def _fn(name: str):
    return _build.function("flash_attention", name, _ARGTYPES[name])


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
    """Launch the kernel for q's dtype.  q (B, H, S, Dh), k and v (B, Hkv,
    S, Dh) of one dtype (bfloat16: the tensor-core kernel; float32: the FMA
    kernel) on one CUDA device, Dh in `HEAD_DIMS` and contiguous; any
    strides over (B, H, S) that keep every row 16-byte aligned (a transposed
    view of a (B, S, H, Dh) projection is taken as it is).  Returns a
    contiguous (B, H, S, Dh) tensor of q's dtype.  Raises on any other
    input, on a tensor that needs a gradient, and when the launch fails."""
    check_shapes(q, k, v)
    require_cuda("q", q)
    require_cuda("k", k, q.device, q.dtype)
    require_cuda("v", v, q.device, q.dtype)
    require_no_grad(
        "flash attention has no backward kernel; training runs the chunked "
        "attention (attn_impl='chunked'), as the reference does, whose "
        "flash kernel has no VJP (run this under torch.inference_mode() or "
        "torch.no_grad())", q=q, k=k, v=v)
    b, h, s, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"Dh={dh} is not one of {HEAD_DIMS}")
    if scale is None:
        scale = dh ** -0.5
    o = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        geom = (ctypes.c_longlong * 21)(*tma_geometry("q", q),
                                        *tma_geometry("k", k),
                                        *tma_geometry("v", v))
        err = _fn("flash_attention_bf16_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dh, geom,
            float(scale), int(bool(causal)), stream_of(q))
    else:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_rows(name, x)
        err = _fn("flash_attention_f32_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h,
            k.shape[1], s, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), int(bool(causal)), stream_of(q))
    if err >= _ENCODE_ERROR:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled failed: "
                           f"CUresult {err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return o
