"""The OCC engine on a mesh, on the CPU: each epoch's points proposed split
over the data axis by spawned gloo ranks, the proposals all-gathered, the
validator re-executed on every rank.

Against the JAX package: 8 ranks on the inputs of the JAX package's
`test_occ_dpmeans_distributed_equals_local` (`dp_stick_breaking_data(512,
seed=1)`, lambda 4, pb 64, k_max 128, two passes), held to the JAX
package's 8-device mesh run (one subprocess, `run_jax`): count and labels
equal, centers within 1e-5 (XLA and torch sum the means in other orders).
Against the port: every rank's result equals this process's one-process
run bit for bit, there and on 4 ranks for OFL, BP-means, the adaptive
cap, the log-depth scan, a `partial_fit` stream, the width-1 bootstrap
epochs, a pb that 4 does not divide (every rank proposes every row) and
`curate(mesh=)`; `run_from_proposals` refuses a mesh with the JAX
package's message.  One 4-rank run computes every case (`mesh4`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import run_jax, run_ranks  # noqa: E402

from repro_torch.core import (  # noqa: E402
    DPMeansTransaction, OCCEngine, occ_bp_means, occ_dp_means, occ_ofl,
)
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.data.curation import curate  # noqa: E402

LAM = 4.0


def _np(tree):
    """A result tree as numpy (NamedTuples to dicts; ints and None kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _np(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return [_np(t) for t in tree]
    return tree


def _assert_same(got, want, path="result"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


# ------------------------------------------------ 8 ranks against the JAX mesh

_JAX = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.core import occ_dp_means
from repro.data import dp_stick_breaking_data
from repro.launch.mesh import compat_mesh
x, _, _ = dp_stick_breaking_data(512, seed=1)
r = occ_dp_means(jnp.asarray(x), 4.0, pb=64, k_max=128, max_iters=2,
                 mesh=compat_mesh((8,), ("data",)))
print(json.dumps({"x": np.asarray(x).tolist(),
                  "count": int(r.pool.count),
                  "z": np.asarray(r.z).tolist(),
                  "centers": np.asarray(r.pool.centers).tolist()}))
"""


def _dp_rank(rank, world, x):
    from repro_torch.launch.mesh import compat_mesh
    mesh = compat_mesh((world,), ("data",), device_type="cpu")
    return _np(occ_dp_means(x, LAM, pb=64, k_max=128, max_iters=2,
                            device="cpu", mesh=mesh))


def test_occ_dp_means_8_ranks_equal_jax_mesh_and_one_process():
    ref = json.loads(run_jax(_JAX).strip().splitlines()[-1])
    x = np.asarray(ref["x"], np.float32)
    out = run_ranks(_dp_rank, 8, x, timeout=120)
    one = _np(occ_dp_means(x, LAM, pb=64, k_max=128, max_iters=2,
                           device="cpu"))
    for got in out:
        assert int(got["pool"]["count"]) == ref["count"]
        np.testing.assert_array_equal(got["z"], np.asarray(ref["z"]))
        np.testing.assert_allclose(got["pool"]["centers"],
                                   np.asarray(ref["centers"], np.float32),
                                   atol=1e-5)
        _assert_same(got, one)


# ----------------------------------------------- 4 ranks, every other path

def _data():
    x = tsyn.dp_stick_breaking_data(512, seed=3)[0]
    xb = tsyn.bp_stick_breaking_data(256, seed=3)[0]
    return x, xb


def _cases(mesh):
    """name -> result of each path (mesh=None: the one-process run)."""
    x, xb = _data()
    kw = dict(device="cpu", mesh=mesh)
    out = {
        "dp_means": occ_dp_means(x, LAM, pb=64, k_max=128, max_iters=2,
                                 **kw),
        "ofl": occ_ofl(x, LAM, 64, key=(0, 7), k_max=256, **kw),
        "bp_means": occ_bp_means(xb, LAM, 32, k_max=32, max_iters=2, **kw),
        "adaptive": occ_dp_means(x, LAM, pb=64, k_max=128, max_iters=2,
                                 validate_cap="adaptive", **kw),
        "logdepth": occ_dp_means(x, LAM, pb=64, k_max=128,
                                 scan_mode="logdepth", **kw),
        "bootstrap": occ_dp_means(x, LAM, pb=64, k_max=128, bootstrap=True,
                                  **kw),
        "pb_not_divisible": occ_dp_means(x, LAM, pb=50, k_max=128, **kw),
    }
    eng = OCCEngine(DPMeansTransaction(LAM, 128), 64, validate_cap="adaptive",
                    **kw)
    stream = [eng.partial_fit(x[lo:hi])
              for lo, hi in ((0, 100), (100, 137), (137, 400), (400, 512))]
    stream.append(eng.flush())
    out["partial_fit"] = (stream, eng.pool, eng.stats)
    out["one_shot"] = OCCEngine(DPMeansTransaction(LAM, 128), 64,
                                validate_cap="adaptive", **kw).run(x)
    rep = curate(x, LAM, pb=64, k_max=128, **kw)
    out["curate"] = (rep.n_clusters, rep.dup_fraction, rep.keep_weight,
                     rep.result)
    return {k: _np(v) for k, v in out.items()}


def _mesh4_rank(rank, world):
    from repro_torch.launch.mesh import compat_mesh
    mesh = compat_mesh((world,), ("data",), device_type="cpu")
    out = _cases(mesh)
    eng = OCCEngine(DPMeansTransaction(LAM, 128), 64, device="cpu",
                    mesh=mesh)
    try:
        eng.run_from_proposals(_data()[0])
    except ValueError as e:
        out["run_from_proposals"] = str(e)
    return out


@pytest.fixture(scope="module")
def mesh4():
    return run_ranks(_mesh4_rank, 4, timeout=150), _cases(None)


CASES = ["dp_means", "ofl", "bp_means", "adaptive", "logdepth", "bootstrap",
         "pb_not_divisible", "partial_fit", "one_shot", "curate"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_path_equals_one_process(mesh4, case):
    out, one = mesh4
    for got in out:
        _assert_same(got[case], one[case], case)


def test_partial_fit_stream_equals_one_shot_on_the_mesh(mesh4):
    """The stream on the mesh equals the one-shot mesh pass: pool, labels
    and per-epoch sends and accepts (the stream's epoch partition is the
    one-shot partition; the adaptive window differs between the two)."""
    out, _ = mesh4
    for got in out:
        stream, pool, stats = got["partial_fit"]
        one = got["one_shot"]
        _assert_same(pool, one["pool"], "pool")
        np.testing.assert_array_equal(
            np.concatenate([r["assign"] for r in stream if r is not None]),
            one["assign"])
        for f in ("proposed", "accepted"):    # the window, cap, adapts
            np.testing.assert_array_equal(stats[f], one["stats"][f])


def test_run_from_proposals_refuses_a_mesh(mesh4):
    out, _ = mesh4
    assert all(o["run_from_proposals"]
               == "run_from_proposals is host-driven; use run() for "
                  "mesh-sharded passes" for o in out)


def test_engine_refuses_a_mesh_of_another_device_type():
    class CudaMesh:
        device_type = "cuda"
    with pytest.raises(ValueError, match="cuda mesh"):
        OCCEngine(DPMeansTransaction(LAM, 16), 8, device="cpu",
                  mesh=CudaMesh())
