"""The backward kernels' plain versions and the autograd Functions of the
port's `ops`, on the CPU.

`ref.rmsnorm_bwd_ref` and `ref.swiglu_bwd_ref` (written out, not autograd)
are held against `jax.vjp` of the JAX package's `ref.rmsnorm_ref` and
`ref.swiglu_ref` on the same numpy inputs, at the tolerances of the
reference's kernel sweeps (`tests/test_kernels.py`): rmsnorm 1e-5 in f32
and 1e-2 in f16, one bf16 ulp of each output's largest value in bf16;
swiglu 1e-6 in f32 (the gradients' scale is a few units).  Both packages
compute in f32 and cast once; the sums run in other orders.  The autograd
Functions (`ops._RMSNormFn`, `ops._SwiGLUFn`), which route a CPU tensor to
the plain forward and backward, pass `torch.autograd.gradcheck` in f64.
The CUDA kernels themselves are held against these plain versions on the
card by `chip_smoke.py`; here their grid arithmetic (plain Python) and the
dispatch are checked, and a torch emulation of the one-read backward's
summation order (its column layout, warp shuffles, warp-ordered sums, the
per-block dw partials and their fold) is held to row independence, to
repeat and to `jax.vjp`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels.swiglu import swiglu_bwd  # noqa: E402

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def _pair(a, dtype):
    """(jax array, torch tensor) of the same values in `dtype`."""
    j = jnp.asarray(a).astype(JNP[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


def _close(got, want, dtype, atol):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "bfloat16":
        atol = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", [(7, 33), (64, 256), (3, 5, 128)])
def test_rmsnorm_bwd_ref_matches_jax_vjp(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.normal(size=shape), dtype)
    jw, tw = _pair(rng.normal(size=shape[-1]), dtype)
    jg, tg = _pair(rng.normal(size=shape), dtype)
    _, vjp = jax.vjp(lambda x, w: jref.rmsnorm_ref(x, w, 1e-6), jx, jw)
    jdx, jdw = vjp(jg)
    dx, dw = ref.rmsnorm_bwd_ref(tx, tw, tg, 1e-6)
    assert dx.dtype == dw.dtype == TORCH[dtype]
    assert dx.shape == shape and dw.shape == shape[-1:]
    atol = 1e-2 if dtype == "float16" else 1e-5
    _close(dx, jdx, dtype, atol)
    # dw sums over every row: scale the bar by the gradient's size
    _close(dw, jdw, dtype, atol * max(1.0, float(np.abs(np.asarray(
        jdw.astype(jnp.float32))).max())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 17), (128, 512), (2, 3, 64)])
def test_swiglu_bwd_ref_matches_jax_vjp(shape, dtype):
    rng = np.random.default_rng(sum(shape) + 1)
    jg, tg = _pair(3.0 * rng.normal(size=shape), dtype)
    ju, tu = _pair(rng.normal(size=shape), dtype)
    jd, td = _pair(rng.normal(size=shape), dtype)
    _, vjp = jax.vjp(jref.swiglu_ref, jg, ju)
    jdg, jdu = vjp(jd)
    dg, du = ref.swiglu_bwd_ref(tg, tu, td)
    assert dg.dtype == du.dtype == TORCH[dtype]
    _close(dg, jdg, dtype, 1e-6)
    _close(du, jdu, dtype, 1e-6)


def test_functions_gradcheck_f64():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(6, 10))).requires_grad_(True)
    w = torch.from_numpy(rng.normal(size=10)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, w: ops._RMSNormFn.apply(x, w, 1e-6, False), (x, w))
    g = torch.from_numpy(2 * rng.normal(size=(4, 9))).requires_grad_(True)
    u = torch.from_numpy(rng.normal(size=(4, 9))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda g, u: ops._SwiGLUFn.apply(g, u, False), (g, u))


def test_ops_route_recorded_calls_through_the_functions(monkeypatch):
    """A call autograd records goes through the Function, whose backward on
    a CPU tensor is the plain backward; an unrecorded call and
    backend="plain" do not; no launch is counted on the CPU."""
    calls = {"rmsnorm": 0, "swiglu": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(ops._ref, "rmsnorm_bwd_ref",
                        counted("rmsnorm", ref.rmsnorm_bwd_ref))
    monkeypatch.setattr(ops._ref, "swiglu_bwd_ref",
                        counted("swiglu", ref.swiglu_bwd_ref))
    ops.reset_launch_counts()
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    y = ops.rmsnorm(x, w)
    assert y.grad_fn.name().endswith("_RMSNormFnBackward")
    z = ops.swiglu(y, y * 2)
    assert z.grad_fn.name().endswith("_SwiGLUFnBackward")
    z.sum().backward()
    assert calls == {"rmsnorm": 1, "swiglu": 1}
    want = torch.autograd.grad(
        ref.swiglu_ref(ref.rmsnorm_ref(x, w), 2 * ref.rmsnorm_ref(x, w))
        .sum(), (x, w))
    torch.testing.assert_close(x.grad, want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(w.grad, want[1], atol=1e-5, rtol=0)
    plain = ops.rmsnorm(x, w, backend="plain")
    assert "RMSNormFn" not in plain.grad_fn.name()
    with torch.no_grad():
        assert ops.rmsnorm(x, w).grad_fn is None
    assert ops.RMSNORM_LAUNCHES == ops.RMSNORM_BWD_LAUNCHES == 0
    assert ops.SWIGLU_LAUNCHES == ops.SWIGLU_BWD_LAUNCHES == 0
    with pytest.raises(ValueError):
        ops.rmsnorm(x, w, backend="cuda")


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        rms.rmsnorm_bwd(x, torch.ones(8), x)
    with pytest.raises(ValueError):
        swiglu_bwd(x, x, x)


@pytest.mark.parametrize("d,aligned,threads", [
    (2048, True, 256), (2560, True, 320), (3072, True, 384),
    (3584, True, 448), (4096, True, 512), (2048, False, 0),
    (3584, False, 0), (1000, True, 0), (33, True, 0), (8192, True, 0),
    (2304, True, 0), (1024, True, 128), (1024, False, 0)])
def test_rmsnorm_bwd_one_read_threads(d, aligned, threads):
    """The dense widths on 16-byte aligned rows take the one-read backward,
    a block of d / 8 threads a row (whole warps, at most 512); every other
    width and unaligned rows take the two-sweep kernel."""
    assert rms.bwd_one_read_threads(d, aligned) == threads
    if threads:
        assert threads % 32 == 0 and threads <= 512
        assert threads * rms.BWD_COLS == d


@pytest.mark.parametrize("rows", [1, 2, 7, 263, 264, 265, 1000, 16384,
                                  16385, 100_000])
def test_rmsnorm_bwd_one_read_grid_covers_every_row(rows):
    """The one-read backward's grid is the constant BWD_ONE_READ_BLOCKS
    (one block a row below it): the blocks' rows (block b: b, b + blocks,
    ...) cover every row once, in ascending order within a block, and each
    block owns at least one row (at most one more than another)."""
    blocks = rms.bwd_one_read_blocks(rows)
    assert blocks == min(rows, rms.BWD_ONE_READ_BLOCKS)
    owned = [list(rms.bwd_rows_of(b, rows, blocks)) for b in range(blocks)]
    assert sorted(r for rs in owned for r in rs) == list(range(rows))
    assert all(rs == sorted(rs) for rs in owned)
    sizes = {len(rs) for rs in owned}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def _fma(a, b, c):
    """f32 fmaf, emulated: the exact product and sum in f64, rounded once
    more to f32 (a double rounding the card does not make: this emulates
    the order, not the bits)."""
    return (a.double() * b.double() + c.double()).float()


def one_read_bwd_emulate(x, w, dy, eps):
    """The one-read backward's arithmetic in its order, f32 (x, dy (rows,
    d), w (d,)): thread t of a row owns columns (t + nt p) 4 + i (f32: two
    packs of four); its ss and sum(w dy x) are fmaf chains over them, the
    32 lanes of a warp sum them by xor shuffles, the warps' sums are added
    in warp order; each block's dw partial sums g (x r) over its rows in
    row order, and the partials are folded as `rmsnorm_dw_kernel` folds
    them (warp k of 8 sums blocks k, k + 8, ...; then the 8 in order)."""
    rows, d = x.shape
    nt = rms.bwd_one_read_threads(d, True)
    v, packs, warps = 4, 2, nt // 32
    cols = torch.tensor([[(t + nt * p) * v + i for p in range(packs)
                          for i in range(v)] for t in range(nt)])
    a, g, h = x[:, cols], dy[:, cols], w[cols]          # (rows, nt, 8)
    ss = torch.zeros(rows, nt)
    dot = torch.zeros(rows, nt)
    for j in range(packs * v):
        ss = _fma(a[..., j], a[..., j], ss)
        dot = _fma(g[..., j] * h[..., j], a[..., j], dot)
    lane = torch.arange(32)
    tot = []
    for val in (ss, dot):
        val = val.view(rows, warps, 32)
        for off in (16, 8, 4, 2, 1):
            val = val + val[..., lane ^ off]
        acc = torch.zeros(rows)
        for k in range(warps):
            acc = acc + val[:, k, 0]
        tot.append(acc)
    r = torch.rsqrt(tot[0] / d + eps)[:, None, None]
    c3 = (r * r * r) * (tot[1] / d)[:, None, None]
    dx = torch.empty_like(x)
    dx[:, cols] = (g * h) * r - a * c3
    blocks = rms.bwd_one_read_blocks(rows)
    partial = torch.zeros(blocks, d)
    for b in range(blocks):
        acc = torch.zeros(nt, packs * v)
        for row in rms.bwd_rows_of(b, rows, blocks):
            acc = acc + g[row] * (a[row] * r[row])
        partial[b, cols] = acc
    sums = []
    for k in range(8):
        acc = torch.zeros(d)
        for b in range(k, blocks, 8):
            acc = acc + partial[b]
        sums.append(acc)
    dw = torch.zeros(d)
    for acc in sums:
        dw = dw + acc
    return dx, dw


@pytest.mark.parametrize("rows,d", [(5, 2048), (300, 2048), (300, 3584),
                                    (300, 1024)])
def test_rmsnorm_bwd_one_read_order_emulated(rows, d):
    """The one-read backward's order: a row's dx alone equals its dx in
    the batch bit for bit (the order depends on d alone), two runs agree
    bit for bit, and dx and dw lie within the card's bar
    (LM_TOL_F32["rmsnorm_bwd"] = 1e-5 of max(1, max |want|)) of `jax.vjp`
    of the JAX package's rmsnorm."""
    rng = np.random.default_rng(rows + d)
    xn, wn, gn = (rng.normal(size=s).astype(np.float32)
                  for s in ((rows, d), (d,), (rows, d)))
    tx, tw, tg = map(torch.from_numpy, (xn, wn, gn))
    dx, dw = one_read_bwd_emulate(tx, tw, tg, 1e-6)
    dx2, dw2 = one_read_bwd_emulate(tx, tw, tg, 1e-6)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    for r in (0, rows // 2, rows - 1):
        alone, _ = one_read_bwd_emulate(tx[r:r + 1], tw, tg[r:r + 1], 1e-6)
        assert torch.equal(alone[0], dx[r])
    _, vjp = jax.vjp(lambda x, w: jref.rmsnorm_ref(x, w, 1e-6),
                     jnp.asarray(xn), jnp.asarray(wn))
    jdx, jdw = (np.asarray(t) for t in vjp(jnp.asarray(gn)))
    for got, want in ((dx, jdx), (dw, jdw)):
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("d,warps", [(64, 4), (2048, 4), (2560, 4),
                                     (4096, 4), (16384, 3), (58112, 1)])
def test_rmsnorm_bwd_warps(d, warps):
    assert rms.bwd_warps(d) == warps
    assert 4 * d * warps <= rms.BWD_SMEM_BYTES


def test_rmsnorm_bwd_warps_refuses_too_wide_rows():
    with pytest.raises(ValueError):
        rms.bwd_warps(58113)


@pytest.mark.parametrize("rows,warps,blocks", [
    (1, 4, 1), (4, 4, 1), (5, 4, 2), (1024, 4, 256), (16384, 4, 512),
    (333, 3, 111)])
def test_rmsnorm_bwd_blocks(rows, warps, blocks):
    """The grid depends on (rows, warps) alone, every block owns at least
    one row, and the ranges cover every row."""
    assert rms.bwd_blocks(rows, warps) == blocks
    per = -(-rows // blocks)
    assert (blocks - 1) * per < rows <= blocks * per
