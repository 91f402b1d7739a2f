"""Dispatch between the hand-written kernels and their plain versions.

The device of the input decides, never a probe of the machine:

  backend="auto"   -> a CUDA tensor launches the kernel (or the call raises),
                      a CPU tensor runs the plain version
  backend="cuda"   -> the kernel; raises for a tensor that is not on a card
  backend="plain"  -> the plain version on any device (comparisons only)

There is no fallback: a CUDA tensor reaches the plain version only when
`backend="plain"` is asked for.  The serving primitives (`serve_assign`,
`serve_topk`, `serve_topk_multiprobe`) add the query-prefix mask of a
padded bucket.  The language model's primitives (`flash_attention`,
`rmsnorm`, `swiglu`) follow the same rule.  Where autograd would record
`rmsnorm` or `swiglu` (training), the call goes through an autograd
Function (`_RMSNormFn`, `_SwiGLUFn`): its forward runs the forward kernel
and saves the inputs, its backward runs the backward kernel, on a CUDA
tensor always (no fallback), and the plain backward versions
(`ref.rmsnorm_bwd_ref`, `ref.swiglu_bwd_ref`) on a CPU tensor.  Under
`torch.inference_mode()` or `no_grad` the forward kernel is called
directly, as before.  Each kernel has a plain-int launch count,
raised by one where the kernel is launched and nowhere else (under a lock:
trainer, client and admission-queue threads launch at once), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.dpmeans_assign import dpmeans_assign as _dpmeans_assign
from repro_torch.kernels.dpmeans_assign import tile_kernel as _tile_kernel
from repro_torch.kernels.flash_attention import (
    check_shapes as _flash_check_shapes,
    flash_attention as _flash_attention,
)
from repro_torch.kernels.rmsnorm import (
    rmsnorm_bwd as _rmsnorm_bwd,
    rmsnorm_launch as _rmsnorm_launch,
)
from repro_torch.kernels.swiglu import (
    swiglu as _swiglu,
    swiglu_bwd as _swiglu_bwd,
)
from repro_torch.kernels.topk_stream import (
    topk_multiprobe_stream as _topk_mp_stream,
    topk_stream as _topk_stream,
)

__all__ = ["assign", "pairwise_argmin", "serve_assign", "serve_topk",
           "serve_topk_multiprobe", "ASSIGN_LAUNCHES",
           "ASSIGN_TILE_LAUNCHES",
           "PAIRWISE_ARGMIN_LAUNCHES", "TOPK_LAUNCHES", "TOPK_MP_LAUNCHES",
           "flash_attention", "rmsnorm", "swiglu", "FLASH_LAUNCHES",
           "RMSNORM_LAUNCHES", "RMSNORM_ONE_READ_LAUNCHES",
           "RMSNORM_TWO_PASS_LAUNCHES", "SWIGLU_LAUNCHES",
           "RMSNORM_BWD_LAUNCHES", "SWIGLU_BWD_LAUNCHES",
           "reset_launch_counts"]

ASSIGN_LAUNCHES = 0
# ASSIGN_LAUNCHES by the kernel the width chose (`dpmeans_assign.tile_kernel`)
ASSIGN_TILE_LAUNCHES = {"fast": 0, "wide": 0, "generic": 0}
PAIRWISE_ARGMIN_LAUNCHES = 0
TOPK_LAUNCHES = 0
TOPK_MP_LAUNCHES = 0
FLASH_LAUNCHES = 0
RMSNORM_LAUNCHES = 0           # both rmsnorm kernels; by kernel below
RMSNORM_ONE_READ_LAUNCHES = 0
RMSNORM_TWO_PASS_LAUNCHES = 0
SWIGLU_LAUNCHES = 0
RMSNORM_BWD_LAUNCHES = 0
SWIGLU_BWD_LAUNCHES = 0
_COUNTS_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    global ASSIGN_LAUNCHES, PAIRWISE_ARGMIN_LAUNCHES, TOPK_LAUNCHES, \
        TOPK_MP_LAUNCHES, FLASH_LAUNCHES, RMSNORM_LAUNCHES, SWIGLU_LAUNCHES, \
        RMSNORM_ONE_READ_LAUNCHES, RMSNORM_TWO_PASS_LAUNCHES, \
        RMSNORM_BWD_LAUNCHES, SWIGLU_BWD_LAUNCHES
    with _COUNTS_LOCK:
        ASSIGN_LAUNCHES = PAIRWISE_ARGMIN_LAUNCHES = 0
        ASSIGN_TILE_LAUNCHES.update(dict.fromkeys(ASSIGN_TILE_LAUNCHES, 0))
        TOPK_LAUNCHES = TOPK_MP_LAUNCHES = 0
        FLASH_LAUNCHES = RMSNORM_LAUNCHES = SWIGLU_LAUNCHES = 0
        RMSNORM_ONE_READ_LAUNCHES = RMSNORM_TWO_PASS_LAUNCHES = 0
        RMSNORM_BWD_LAUNCHES = SWIGLU_BWD_LAUNCHES = 0


def _use_kernel(x: torch.Tensor, backend: str) -> bool:
    if backend == "plain":
        return False
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    if x.device.type == "cuda":
        return True
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got {x.device}")
    return False


def _count_tensor(count, k: int, device) -> torch.Tensor:
    if count is None:
        count = k
    if isinstance(count, torch.Tensor):
        return count.to(device=device, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(count), dtype=torch.int32, device=device)


def assign(x, centers, mask=None, count=None, backend: str = "auto"):
    """Nearest-center assignment: THE OCC propose primitive.

    x (N, D), centers (K, D), mask (K,) bool, count (optional int or
    int32 tensor) bounding the valid prefix.  Returns (d2min (N,), idx (N,)
    int32) with (inf, -1) where no valid center exists.  d2min is f32 from
    the kernel and the input dtype from the plain version, as in the JAX
    package.  The kernel skips center tiles past `count`; the plain version
    folds `count` into the mask, which the pool invariant makes a no-op.
    """
    global ASSIGN_LAUNCHES
    k = centers.shape[0]
    if _use_kernel(x, backend):
        if mask is None:
            mask = torch.ones((k,), dtype=torch.bool, device=x.device)
        out = _dpmeans_assign(x, centers, mask, _count_tensor(count, k, x.device))
        with _COUNTS_LOCK:
            ASSIGN_LAUNCHES += 1
            ASSIGN_TILE_LAUNCHES[_tile_kernel(x.shape[-1])] += 1
        return out
    if mask is None:
        mask = torch.ones((k,), dtype=torch.bool, device=x.device)
    if count is not None:
        mask = mask & (torch.arange(k, device=x.device) < count)
    return _ref.assign_ref(x, centers, mask)


def pairwise_argmin(x, centers, mask=None, backend: str = "auto"):
    """Kernel/plain pair without the count restriction, for parity tests.
    As in the JAX package the plain version computes in f32 and returns
    argmin 0 (not -1) for a row with no valid center; the kernel returns -1
    there."""
    global PAIRWISE_ARGMIN_LAUNCHES
    k = centers.shape[0]
    if _use_kernel(x, backend):
        if mask is None:
            mask = torch.ones((k,), dtype=torch.bool, device=x.device)
        out = _dpmeans_assign(x, centers, mask, _count_tensor(None, k, x.device))
        with _COUNTS_LOCK:
            PAIRWISE_ARGMIN_LAUNCHES += 1
        return out
    return _ref.pairwise_argmin_ref(x, centers, mask)


def _mask_queries(d2, idx, n_valid):
    """Rows at or past `n_valid` (an int or a device scalar) become
    (inf, -1): padding rows of a bucket can never alias a real answer."""
    if n_valid is None:
        return d2, idx
    ok = torch.arange(d2.shape[0], device=d2.device) < n_valid
    if d2.dim() == 2:
        ok = ok[:, None]
    return torch.where(ok, d2, torch.inf), torch.where(ok, idx, -1)


def serve_assign(x, centers, mask=None, count=None, n_valid=None,
                 backend: str = "auto"):
    """Bucket-padded assignment, the serving plane's query primitive:
    `assign` plus query-prefix masking (`n_valid` real rows; the padding
    rows of the bucket come back as (inf, -1))."""
    d2, idx = assign(x, centers, mask, count=count, backend=backend)
    return _mask_queries(d2, idx, n_valid)


def _pad_columns(d2, idx, k: int):
    """(inf, -1) columns up to k (k may exceed the center capacity)."""
    pad = k - d2.shape[1]
    if pad <= 0:
        return d2, idx
    n = d2.shape[0]
    return (torch.cat([d2, d2.new_full((n, pad), torch.inf)], 1),
            torch.cat([idx, idx.new_full((n, pad), -1)], 1))


def _next_pow2(n: int) -> int:
    # A local copy of core.occ.next_pow2: core.occ imports this module.
    p = 1
    while p < n:
        p <<= 1
    return p


def serve_topk(x, centers, k: int, mask=None, count=None, n_valid=None,
               backend: str = "auto"):
    """k nearest centers per query: (d2 (N, k) ascending, idx (N, k) int32).

    The same count-prefix and query-prefix masking as `serve_assign`;
    masked, padded and beyond-count slots are (inf, -1), and distance ties
    go to the lower index on both paths, so `topk[:, :1]` equals
    `serve_assign`.  The kernel reads `count` on the device and stops its
    center loop there.  On the plain path a host-int `count` first slices
    the centers to the power-of-two active prefix (min 8), which changes no
    surviving distance.  k may exceed the capacity: the extra columns are
    (inf, -1).  The kernel takes any k >= 1: above 64 its wide route.
    """
    global TOPK_LAUNCHES
    kc = centers.shape[0]
    if mask is None:
        mask = torch.ones((kc,), dtype=torch.bool, device=centers.device)
    if _use_kernel(x, backend):
        kk = min(k, kc)
        d2, idx = _topk_stream(x, centers, mask,
                               _count_tensor(count, kc, x.device), kk)
        with _COUNTS_LOCK:
            TOPK_LAUNCHES += 1
    else:
        if count is not None:
            mask = mask & (torch.arange(kc, device=centers.device) < count)
        if count is not None and not isinstance(count, torch.Tensor):
            kp = min(kc, max(_next_pow2(max(int(count), 1)), 8))
            centers, mask = centers[:kp], mask[:kp]
        d2, idx = _ref.topk_ref(x, centers, min(k, centers.shape[0]), mask)
    d2, idx = _pad_columns(d2, idx, k)
    return _mask_queries(d2, idx, n_valid)


def serve_topk_multiprobe(x, fine, fine_ids, fine_mask, cells, member,
                          k: int, u_count=None, n_valid=None,
                          backend: str = "auto"):
    """Top-k over a hierarchical snapshot's probed fine shards.

    x (B, D); fine (n_cells, S, D), fine_ids / fine_mask (n_cells, S) as
    `serving.snapshot.build_hier` lays them out; cells (U,) the
    microbatch's probed-cell union (packed ascending, -1 pad); member (B, U)
    per-query membership; `u_count` the union's real length (an int or a
    device scalar).  Returns (d2 (B, k), idx (B, k)) with idx flat-snapshot
    ids.  With every cell in the union and member all true the result
    equals `serve_topk` on the flat buffers (on the card bitwise, by the
    kernels' shared arithmetic).  The plain version gathers the union and
    ignores `u_count` (its padding ranks are -1 and match nothing).
    """
    global TOPK_MP_LAUNCHES
    if _use_kernel(x, backend):
        d2, idx = _topk_mp_stream(
            x, fine, fine_ids, fine_mask, cells, member,
            _count_tensor(u_count, cells.shape[0], x.device), k)
        with _COUNTS_LOCK:
            TOPK_MP_LAUNCHES += 1
    else:
        d2, idx = _ref.topk_multiprobe_ref(x, fine, fine_ids, fine_mask,
                                           cells, member, k)
    return _mask_queries(d2, idx, n_valid)


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None,
                    backend: str = "auto"):
    """GQA attention forward: q (B, H, S, Dh), k and v (B, Hkv, S, Dh) ->
    (B, H, S, Dh) in q's dtype, f32 math, causal by default.  The JAX
    wrapper's contract (H % Hkv == 0, S a multiple of min(128, S)) raises
    ValueError on every backend."""
    global FLASH_LAUNCHES
    if _use_kernel(q, backend):
        out = _flash_attention(q, k, v, causal=causal, scale=scale)
        with _COUNTS_LOCK:
            FLASH_LAUNCHES += 1
        return out
    _flash_check_shapes(q, k, v)
    return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)


def _records(*tensors) -> bool:
    """Autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rmsnorm_fwd(x, weight, eps, use_kernel: bool):
    global RMSNORM_LAUNCHES, RMSNORM_ONE_READ_LAUNCHES, \
        RMSNORM_TWO_PASS_LAUNCHES
    if not use_kernel:
        return _ref.rmsnorm_ref(x, weight, eps=eps)
    out, packs = _rmsnorm_launch(x, weight, eps=eps)
    with _COUNTS_LOCK:
        RMSNORM_LAUNCHES += 1
        if packs:
            RMSNORM_ONE_READ_LAUNCHES += 1
        else:
            RMSNORM_TWO_PASS_LAUNCHES += 1
    return out


class _RMSNormFn(torch.autograd.Function):
    """rmsnorm with a backward: the forward kernel (or, for a CPU tensor,
    the plain version), then the backward kernel (the plain backward for a
    CPU tensor).  Saves x and w; the backward recomputes r from x."""

    @staticmethod
    def forward(ctx, x, weight, eps, use_kernel):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.use_kernel = eps, use_kernel
        return _rmsnorm_fwd(x, weight, eps, use_kernel)

    @staticmethod
    def backward(ctx, dy):
        global RMSNORM_BWD_LAUNCHES
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        if not ctx.use_kernel:
            dx, dw = _ref.rmsnorm_bwd_ref(x, weight, dy, ctx.eps)
        else:
            dx, dw = _rmsnorm_bwd(x, weight, dy, ctx.eps)
            with _COUNTS_LOCK:
                RMSNORM_BWD_LAUNCHES += 1
        return dx, dw, None, None


def rmsnorm(x, weight, eps: float = 1e-6, backend: str = "auto"):
    """(x * rsqrt(mean(x^2) + eps)) * weight over the last dim, f32 math,
    in x's dtype.  A launch is counted in RMSNORM_LAUNCHES and in the count
    of the kernel the launch reports it ran (one read or two passes).
    Where autograd records the call (and backend is not "plain", whose
    ops autograd differentiates as they are), it goes through `_RMSNormFn`,
    whose backward launches are counted in RMSNORM_BWD_LAUNCHES."""
    use_kernel = _use_kernel(x, backend)
    if backend != "plain" and _records(x, weight):
        return _RMSNormFn.apply(x, weight, eps, use_kernel)
    return _rmsnorm_fwd(x, weight, eps, use_kernel)


def _swiglu_fwd(gate, up, use_kernel: bool):
    global SWIGLU_LAUNCHES
    if not use_kernel:
        return _ref.swiglu_ref(gate, up)
    out = _swiglu(gate, up)
    with _COUNTS_LOCK:
        SWIGLU_LAUNCHES += 1
    return out


class _SwiGLUFn(torch.autograd.Function):
    """swiglu with a backward: the forward kernel (or, for a CPU tensor, the
    plain version), then the backward kernel (the plain backward for a CPU
    tensor).  Saves gate and up."""

    @staticmethod
    def forward(ctx, gate, up, use_kernel):
        ctx.save_for_backward(gate, up)
        ctx.use_kernel = use_kernel
        return _swiglu_fwd(gate, up, use_kernel)

    @staticmethod
    def backward(ctx, dy):
        global SWIGLU_BWD_LAUNCHES
        gate, up = ctx.saved_tensors
        dy = dy.contiguous()
        if not ctx.use_kernel:
            dgate, dup = _ref.swiglu_bwd_ref(gate, up, dy)
        else:
            dgate, dup = _swiglu_bwd(gate, up, dy)
            with _COUNTS_LOCK:
                SWIGLU_BWD_LAUNCHES += 1
        return dgate, dup, None


def swiglu(gate, up, backend: str = "auto"):
    """silu(gate) * up elementwise, f32 math, in gate's dtype.  Where
    autograd records the call (and backend is not "plain"), it goes through
    `_SwiGLUFn`, whose backward launches are counted in
    SWIGLU_BWD_LAUNCHES."""
    use_kernel = _use_kernel(gate, backend)
    if backend != "plain" and _records(gate, up):
        return _SwiGLUFn.apply(gate, up, use_kernel)
    return _swiglu_fwd(gate, up, use_kernel)
