"""Mesh serving on the CPU: every rank (a spawned gloo process) holds the
published snapshot, a microbatch's rows are split over the data axis, each
rank scores its block and one all-gather gives every rank the whole
response.

On 4 ranks and on a 1-rank mesh (the JAX package's
`test_service_with_mesh_replicated_snapshot` case), score and top-k (k 2,
and k 100 past the register-list kernels' 64), for buckets the axis
divides and one it does not (1 row: every rank scores it), and through
`ModelRouter(mesh=)`, equal the meshless service's bit for bit, version
included.  Multi-probe serving and the admission queue are refused with a
mesh, as is a mesh of another device type.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh import run_ranks  # noqa: E402

from repro_torch.core import DPMeansTransaction, OCCEngine  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ClusterService, ModelRouter, SnapshotStore,
)

REQUESTS = [("score", 48, 0), ("score", 5, 0), ("score", 1, 0),
            ("topk", 16, 2), ("topk", 33, 100), ("topk", 1, 100)]


def _trained(store):
    x = tsyn.dp_stick_breaking_data(1024, seed=5)[0]
    OCCEngine(DPMeansTransaction(1.0, 256), 128, device="cpu",
              publish=store.publish_pass).run(x)
    return x


def _answers(svc, x) -> list:
    out = []
    for kind, n, k in REQUESTS:
        r = svc.score(x[:n]) if kind == "score" else svc.topk(x[:n], k=k)
        out.append((r.version, r.bucket, r.labels, r.scores))
    return out


def _serve_rank(rank, world):
    from repro_torch.launch.mesh import compat_mesh
    mesh = compat_mesh((world,), ("data",), device_type="cpu")
    store = SnapshotStore(device="cpu")
    x = _trained(store)
    meshed = ClusterService(store, mesh=mesh, min_bucket=1)
    plain = ClusterService(store, min_bucket=1)
    router = ModelRouter(mesh=mesh, device="cpu", min_bucket=1)
    rstore = router.add_model("m")
    _trained(rstore)
    return {"mesh": _answers(meshed, x), "plain": _answers(plain, x),
            "router": _answers(router.service("m"), x),
            "capacity": store.latest().capacity}


def _assert_equal(got, want):
    assert len(got) == len(want)
    for (v, b, lab, sc), (v0, b0, lab0, sc0) in zip(got, want):
        assert (v, b) == (v0, b0)
        np.testing.assert_array_equal(lab, lab0)
        np.testing.assert_array_equal(sc, sc0)


@pytest.mark.parametrize("world", [4, 1])
def test_mesh_service_equals_meshless_service(world):
    out = run_ranks(_serve_rank, world, timeout=120)
    assert out[0]["capacity"] > 64     # k 100 reaches past the 64 buckets
    for o in out:
        _assert_equal(o["mesh"], out[0]["plain"])
        _assert_equal(o["router"], out[0]["plain"])
        assert o["mesh"][4][2].shape == (33, 100)


def test_mesh_service_refuses_probes_coalescing_and_other_devices():
    store = SnapshotStore(device="cpu")
    mesh = SimpleNamespace(device_type="cpu")
    with pytest.raises(ValueError, match="multi-probe"):
        ClusterService(store, mesh=mesh, probes=2)
    with pytest.raises(ValueError, match="coalescing"):
        ClusterService(store, mesh=mesh, coalesce=True)
    with pytest.raises(ValueError, match="cuda mesh"):
        ClusterService(store, mesh=SimpleNamespace(device_type="cuda"))
