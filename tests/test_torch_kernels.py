"""The port's nearest-center primitive against the JAX package, on the CPU.

On the CPU the port's `ops.assign` / `pairwise_argmin` run the plain
version (`repro_torch.kernels.ref`); each case feeds the same numpy arrays
to it, to the JAX reference oracle (`backend="ref"`) and to the Pallas
kernel in interpret mode.  Bar: indices identical, f32 distances within
rtol = atol = 1e-5 (XLA and torch sum the D products in different orders).
The CUDA kernel itself is held against the plain version on the card by
`chip_smoke.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.dpmeans_assign import dpmeans_assign  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(n, k, d, count, holes=False, dup=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    if dup:
        c[k // 2:] = c[:k - k // 2]
    mask = np.arange(k) < count
    if holes:
        mask &= rng.uniform(size=k) > 0.3
    return x, c, mask, count


CASES = {
    "ragged": (37, 53, 16, 53),
    "count_prefix": (64, 96, 16, 41),
    "holes": (50, 70, 12, 70),
    "count0": (20, 32, 16, 0),
    "duplicates": (40, 24, 8, 24),
    "one_row": (1, 40, 16, 33),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_assign_matches_jax_ref_and_interpret(name):
    n, k, d, count = CASES[name]
    x, c, mask, count = _case(n, k, d, count, holes=name == "holes",
                              dup=name == "duplicates", seed=len(name))
    d2t, it = tops.assign(torch.from_numpy(x), torch.from_numpy(c),
                          torch.from_numpy(mask), count=count)
    assert d2t.dtype == torch.float32 and it.dtype == torch.int32
    jc = jnp.asarray(count, jnp.int32)
    for backend, kw in (("ref", {}),
                        ("pallas", dict(block_n=16, block_k=8))):
        d2j, ij = jops.assign(jnp.asarray(x), jnp.asarray(c),
                              jnp.asarray(mask), count=jc, backend=backend,
                              **kw)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), **TOL)
    if name == "count0":
        assert np.all(np.isinf(d2t.numpy())) and np.all(it.numpy() == -1)
    if name == "duplicates":
        assert np.all(it.numpy() < k - k // 2)      # lowest index wins


def test_pairwise_argmin_matches_jax():
    x, c, mask, _ = _case(45, 60, 16, 60, holes=True, seed=7)
    d2t, it = tops.pairwise_argmin(torch.from_numpy(x), torch.from_numpy(c),
                                   torch.from_numpy(mask))
    for backend, kw in (("ref", {}),
                        ("pallas", dict(block_n=16, block_k=8))):
        d2j, ij = jops.pairwise_argmin(jnp.asarray(x), jnp.asarray(c),
                                       jnp.asarray(mask), backend=backend,
                                       **kw)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), **TOL)


def test_assign_plain_is_input_dtype():
    x, c, mask, _ = _case(8, 8, 4, 8, seed=1)
    d2, _ = tops.assign(torch.from_numpy(x).double(),
                        torch.from_numpy(c).double(), torch.from_numpy(mask))
    assert d2.dtype == torch.float64


def test_cpu_tensors_never_launch_and_cuda_backend_raises():
    x, c, mask, count = _case(16, 16, 4, 10, seed=2)
    xt, ct, mt = map(torch.from_numpy, (x, c, mask))
    tops.reset_launch_counts()
    tops.assign(xt, ct, mt, count=count)
    tops.pairwise_argmin(xt, ct, mt)
    assert tops.ASSIGN_LAUNCHES == 0 and tops.PAIRWISE_ARGMIN_LAUNCHES == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.assign(xt, ct, mt, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tops.pairwise_argmin(xt, ct, mt, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tops.assign(xt, ct, mt, backend="auto-ish")
    # the kernel wrapper itself refuses a CPU tensor before any build
    with pytest.raises(ValueError, match="CUDA"):
        dpmeans_assign(xt, ct, mt, torch.tensor([10], dtype=torch.int32))
    # the plain backend is allowed on any device
    d2p, ip = tops.assign(xt, ct, mt, count=count, backend="plain")
    d2a, ia = tops.assign(xt, ct, mt, count=count)
    assert torch.equal(d2p, d2a) and torch.equal(ip, ia)
