"""The port's language-model primitives against the JAX package, on the CPU.

`flash_attention_ref`, `rmsnorm_ref` and `swiglu_ref` (the plain versions
the port's `ops` run for CPU tensors) are held against the JAX package's
Pallas kernels in interpret mode and against its reference oracles, on the
same numpy inputs, with the sweeps of `tests/test_kernels.py`.  Bars:
flash atol 2e-5 (f32; XLA and torch sum the products in different
orders), rmsnorm 1e-5 in f32 and one bf16 ulp of the output in bf16,
swiglu 1e-6.  The CUDA kernels themselves are held against the plain
versions on the card by `chip_smoke.py`; here the dispatch is checked: a
CPU tensor runs the plain version, asks for the kernel raise, and no
launch is counted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel,
)
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel  # noqa: E402
from repro_torch.kernels.swiglu import swiglu as swiglu_kernel  # noqa: E402


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,dh", [(1, 4, 4, 128, 32),
                                          (2, 8, 2, 128, 32),
                                          (2, 4, 1, 256, 64),
                                          (1, 8, 1, 48, 16)])
def test_flash_attention_ref_matches_jax(b, h, hkv, s, dh, causal):
    rng = np.random.default_rng(b * 1000 + h * 100 + s + dh)
    q, k, v = (_normal(rng, (b, h, s, dh)), _normal(rng, (b, hkv, s, dh)),
               _normal(rng, (b, hkv, s, dh)))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, dh)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    want_pallas = jops.flash_attention(jq, jk, jv, causal=causal,
                                       backend="pallas", block_q=64,
                                       block_k=64)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)


def test_flash_attention_ref_scale_and_bf16():
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (1, 4, 64, 32)), _normal(rng, (1, 2, 64, 32)),
               _normal(rng, (1, 2, 64, 32)))
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), scale=0.3)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    # bf16 in, bf16 out, f32 math: within one bf16 ulp of the f32 result
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got16 = tref.flash_attention_ref(*tb)
    assert got16.dtype == torch.bfloat16
    want32 = tref.flash_attention_ref(*[t.float() for t in tb])
    ulp = 2.0 ** -7 * want32.abs().max().item()
    assert (got16.float() - want32).abs().max().item() <= ulp


@pytest.mark.parametrize("bad", ["heads", "seq", "rank"])
def test_flash_attention_contract_raises_on_every_backend(bad):
    q = torch.zeros((1, 4, 128, 16))
    k = torch.zeros((1, 2, 128, 16))
    if bad == "heads":
        q = torch.zeros((1, 3, 128, 16))
    elif bad == "seq":
        q, k = torch.zeros((1, 4, 200, 16)), torch.zeros((1, 2, 200, 16))
    else:
        q = torch.zeros((4, 128, 16))
    for backend in ("auto", "plain"):
        with pytest.raises(ValueError):
            tops.flash_attention(q, k, k, backend=backend)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (2^(e-7) for |x| in [2^e, 2^(e+1)))."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("shape", [(7, 33), (64, 256), (3, 5, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x, w = _normal(rng, shape), _normal(rng, shape[-1:])
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    got = tops.rmsnorm(tx, tw)
    assert got.dtype == tdt and got.shape == shape
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    for want in (jref.rmsnorm_ref(jx, jw),
                 jops.rmsnorm(jx, jw, backend="pallas", block_rows=16)):
        g = got.float().numpy()
        wnt = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, wnt, atol=1e-5, rtol=0)
        else:
            assert (np.abs(g - wnt) <= _ulp_bf16(wnt)).all()


@pytest.mark.parametrize("shape", [(5, 17), (128, 512), (2, 3, 64)])
def test_swiglu_ref_matches_jax(shape):
    rng = np.random.default_rng(shape[-1])
    g, u = _normal(rng, shape), _normal(rng, shape)
    got = tops.swiglu(torch.from_numpy(g), torch.from_numpy(u))
    assert got.dtype == torch.float32 and got.shape == shape
    jg, ju = jnp.asarray(g), jnp.asarray(u)
    for want in (jref.swiglu_ref(jg, ju),
                 jops.swiglu(jg, ju, backend="pallas", block_rows=8)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


def test_swiglu_ref_bf16_within_one_ulp():
    rng = np.random.default_rng(3)
    g, u = _normal(rng, (9, 40)) * 3, _normal(rng, (9, 40))
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tu = torch.from_numpy(u).to(torch.bfloat16)
    got = tops.swiglu(tg, tu)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.swiglu_ref(jnp.asarray(g, jnp.bfloat16),
                                      jnp.asarray(u, jnp.bfloat16)),
                      np.float32)
    assert (np.abs(got.float().numpy() - want) <= _ulp_bf16(want)).all()


def _lm_calls():
    q = torch.zeros((1, 2, 16, 16))
    x = torch.ones((3, 8))
    return {"flash_attention": lambda b: tops.flash_attention(q, q, q,
                                                              backend=b),
            "rmsnorm": lambda b: tops.rmsnorm(x, torch.ones(8), backend=b),
            "swiglu": lambda b: tops.swiglu(x, x, backend=b)}


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "swiglu"])
def test_cpu_dispatch_runs_plain_and_counts_nothing(name):
    call = _lm_calls()[name]
    tops.reset_launch_counts()
    a, b = call("auto"), call("plain")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        call("cuda")
    with pytest.raises(ValueError):
        call("nope")
    assert (tops.FLASH_LAUNCHES, tops.RMSNORM_LAUNCHES,
            tops.SWIGLU_LAUNCHES) == (0, 0, 0)


@pytest.mark.parametrize("name", ["flash_attention", "rmsnorm", "swiglu"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    q = torch.zeros((1, 2, 16, 16))
    x = torch.ones((3, 8))
    call = {"flash_attention": lambda: flash_kernel(q, q, q),
            "rmsnorm": lambda: rmsnorm_kernel(x, torch.ones(8)),
            "swiglu": lambda: swiglu_kernel(x, x)}[name]
    with pytest.raises(ValueError, match="CUDA"):
        call()
