"""The port's mesh on the CPU: `launch/mesh.py`, `distributed/shardings.py`
and `distributed/elastic.py`, the compressed psum and the elastic restore,
against the JAX package.

The port's side runs as spawned gloo ranks (`run_ranks`: one process a
rank, one torch thread each, a timeout for the whole run); the JAX side
runs in one subprocess with host-device emulation (`run_jax`, as
`tests/test_sharded.py` does), shared by a module-scoped fixture.  Neither
the ranks nor this process import JAX: the rules that need the JAX package
in process (plans, specs) import it inside the test.

Bars: plans and specs equal; the compressed psum equal to the JAX
shard_map bit for bit (integer sums are exact, and each rank's residual
follows the reference's order of operations); the restored array equal.
The other mesh tests (`test_torch_mesh_occ.py`,
`test_torch_mesh_serving.py`) import `run_ranks` from here.
"""
import json
import multiprocessing
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.shardings import (  # noqa: E402
    Sharding, ShardCtx, axes_that_divide, batch_spec, param_specs,
    placements, shard_ctx, spec_for,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- harness

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, out_dir, args, timeout):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    init_ranks(rank, world, f"tcp://localhost:{port}", device_type="cpu",
               timeout_s=timeout)
    out = fn(rank, world, *args)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 120.0) -> list:
    """fn(rank, world, *args) on `world` spawned gloo ranks on the CPU;
    returns each rank's (pickled) result.  A rank that fails, or a run past
    `timeout` seconds, fails the test (the others are killed)."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, port, out_dir, args,
                                   timeout))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert not hung, f"ranks {hung} still running after {timeout} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
        out = []
        for r in range(world):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_jax(script: str, devices: int = 8, timeout: float = 300.0) -> str:
    """`script` in a subprocess with `devices` emulated host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# ---------------------------------------------------------------- the JAX side

_JAX = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import compressed_psum_with_feedback, ef_init
from repro.distributed.shardings import compat_shard_map
mesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
rng = np.random.default_rng(0)
g_all = rng.normal(size=(4, 64)).astype(np.float32)
g_all[2, 5] = 7.5          # one rank's outlier sets the shared scale
def body(g):
    grads = {"w": g[0]}
    out, ef2 = compressed_psum_with_feedback(grads, ef_init(grads), "pod")
    return out["w"], ef2.residual["w"]
summed, resid = compat_shard_map(body, mesh=mesh, in_specs=P("pod"),
                                 out_specs=(P(), P("pod")))(jnp.asarray(g_all))
print(json.dumps({"g": g_all.tolist(),
                  "summed": np.asarray(summed).tolist(),
                  "resid": np.asarray(resid).reshape(4, 64).tolist()}))
"""


@pytest.fixture(scope="module")
def jax_side():
    out = json.loads(run_jax(_JAX, devices=4).strip().splitlines()[-1])
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


# --------------------------------------------------------- mesh construction

def test_importing_the_mesh_modules_touches_no_process_group():
    import torch.distributed as dist
    import repro_torch.distributed.elastic  # noqa: F401
    import repro_torch.launch.mesh  # noqa: F401
    assert not dist.is_initialized()


def test_compat_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import compat_mesh
    with pytest.raises(RuntimeError, match="process group"):
        compat_mesh((1,), ("data",), device_type="cpu")


def test_backend_for():
    from repro_torch.launch.mesh import backend_for
    assert backend_for("cpu", 4) == "gloo"
    # more ranks than cards: they share a card, so gloo
    assert backend_for("cuda", 4 + torch.cuda.device_count()) == "gloo"


def _mesh_rank(rank, world):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.shardings import full_tensor
    from repro_torch.launch.mesh import axis_sizes, make_test_mesh
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    w = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    fulls = [bool(torch.equal(full_tensor(distribute_tensor(w, mesh, p)), w))
             for p in ([Shard(0), Shard(0)], [Replicate(), Shard(1)],
                       [Shard(1), Shard(0)], [Replicate(), Replicate()])]
    return {"sizes": axis_sizes(mesh), "full_tensor": fulls,
            "data_rank": mesh.get_local_rank("data"),
            "placements": _names(placements(
                Sharding(mesh, ("data", None, "model")))),
            "shape_error": _production_error()}


def _names(pls) -> list[tuple]:
    return [(type(p).__name__, getattr(p, "dim", None)) for p in pls]


def _production_error():
    from repro_torch.launch.mesh import make_production_mesh
    try:
        make_production_mesh(device_type="cpu")
    except RuntimeError as e:       # torch's own: the world is too small
        return str(e)
    return None


def test_test_mesh_on_four_ranks():
    out = run_ranks(_mesh_rank, 4, timeout=60)
    assert [o["sizes"] for o in out] == [{"data": 2, "model": 2}] * 4
    assert [o["data_rank"] for o in out] == [0, 0, 1, 1]
    assert out[0]["placements"] == [("Shard", 0), ("Shard", 2)]
    assert all(o["full_tensor"] == [True] * 4 for o in out)
    assert all("256" in o["shape_error"] for o in out)


# ------------------------------------------------------------ plans and specs

class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


PLAN_MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 4, "model": 2},
               {"data": 8}]


@pytest.mark.parametrize("n_failed", [0, 1, 3, 40])
@pytest.mark.parametrize("shape", PLAN_MESHES, ids=str)
def test_plan_shrunk_mesh_equals_jax(shape, n_failed):
    from repro.distributed.elastic import plan_shrunk_mesh as jplan
    from repro_torch.distributed.elastic import plan_shrunk_mesh
    try:
        want = jplan(FakeMesh(shape), n_failed=n_failed)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="too many failures"):
            plan_shrunk_mesh(FakeMesh(shape), n_failed=n_failed)
        return
    got = plan_shrunk_mesh(FakeMesh(shape), n_failed=n_failed)
    assert (got.old_shape, got.new_shape, got.lost_ranks) == \
        (want.old_shape, want.new_shape, want.lost_ranks)
    assert got.new_axis_sizes == want.new_axis_sizes


def _jspec(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


SPEC_MESHES = [{"pod": 2, "data": 16, "model": 16}, {"data": 16, "model": 16},
               {"data": 4, "model": 2}]


def test_axes_batch_and_spec_rules_equal_jax():
    from repro.distributed import shardings as js
    for shape in SPEC_MESHES:
        jctx, tctx = js.ShardCtx(mesh=FakeMesh(shape)), ShardCtx(
            mesh=FakeMesh(shape))
        for dim in (1, 2, 7, 8, 32, 256, 4096):
            for axes in (("pod", "data"), ("model",), ("data", "model")):
                assert axes_that_divide(dim, axes, tctx) == \
                    js.axes_that_divide(dim, axes, jctx)
            assert batch_spec(dim, tctx) == js.batch_spec(dim, jctx)
        for shp, elems in (((256, 4096, 8, 128),
                            (("pod", "data"), None, "model", None)),
                           ((2, 4096, 32, 128),
                            (("pod", "data"), None, "model", None))):
            assert spec_for(shp, elems, tctx) == \
                _jspec(js.spec_for(shp, elems, jctx))


def _arch_names():
    from repro_torch.configs import ARCHS
    return sorted(ARCHS)


@pytest.mark.parametrize("arch", _arch_names())
def test_param_specs_equal_jax_leaf_for_leaf(arch):
    """`param_specs` on the port's (meta) parameters of a reduced model of
    each family equals the JAX package's on its parameter tree, leaf for
    leaf, on each FakeMesh shape; a layer of a stacked segment is a row of
    the JAX leaf, whose leading stack dim is whole."""
    import jax
    from repro.configs import ARCHS as JARCHS, reduced as jreduced
    from repro.distributed import shardings as js
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import build_model
    from repro_torch.models.model import layer_of, stacked_segments
    jm = jbuild(jreduced(JARCHS[arch]))
    jtree = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    model = build_model(reduced(get_arch(arch)), device="meta")
    params = dict(model.named_parameters())
    stacked = stacked_segments(params)
    for shape in SPEC_MESHES:
        jspecs = js.param_specs(jtree, js.ShardCtx(mesh=FakeMesh(shape)))
        got = param_specs(params, ShardCtx(mesh=FakeMesh(shape)))
        assert set(got) == set(params)
        for name, spec in got.items():
            at = layer_of(name)
            path = (at[0].split("/") + [at[2]]) if at else name.split(".")
            node = jspecs
            for key in path:
                node = node[key]
            want = _jspec(node)
            if at is not None and at[0] in stacked:
                assert want[0] is None, name
                want = want[1:]
            assert spec == want, (shape, name, spec, want)


def test_placements_of_a_sharding():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = placements(Sharding(mesh, (("pod", "data"), None, "model")))
    assert _names(got) == [("Shard", 0), ("Shard", 0), ("Shard", 2)]
    assert _names(placements(Sharding(mesh, (None,)))) == \
        [("Replicate", None)] * 3


def test_shard_ctx_installs_and_restores():
    from repro_torch.distributed.shardings import current_ctx
    m = FakeMesh({"data": 2})
    with shard_ctx(m, zero3=False) as ctx:
        assert current_ctx() is ctx and ctx.axis_size("data") == 2
        assert ctx.present_data_axes == ("data",)
    assert current_ctx().mesh is None


# ------------------------------------------------------- the compressed psum

def _psum_rank(rank, world, g_all):
    from repro_torch.distributed.shardings import shard_ctx as ctx_of
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.optim.compression import (
        compressed_psum_with_feedback, ef_init,
    )
    mesh = compat_mesh((world,), ("pod",), device_type="cpu")
    grads = {"w": torch.from_numpy(g_all[rank].copy())}
    with ctx_of(mesh):
        out, ef = compressed_psum_with_feedback(grads, ef_init(grads), "pod")
    return out["w"].numpy(), ef.residual["w"].numpy()


def test_compressed_psum_equals_jax_shard_map(jax_side):
    out = run_ranks(_psum_rank, 4, jax_side["g"], timeout=60)
    for rank, (summed, resid) in enumerate(out):
        np.testing.assert_array_equal(summed, jax_side["summed"])
        np.testing.assert_array_equal(resid, jax_side["resid"][rank])
    # the JAX test's own bound against the exact sum
    g = jax_side["g"]
    err = np.abs(out[0][0] - g.sum(0)).max()
    assert err <= 4 * (np.abs(g).max() / 127) + 1e-6


# ------------------------------------------------------ the elastic restore

def _elastic_rank(rank, world, ckpt_dir):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.elastic import (
        build_mesh_from_plan, plan_shrunk_mesh,
    )
    from repro_torch.distributed.shardings import full_tensor
    from repro_torch.launch.mesh import axis_sizes, compat_mesh
    mesh = compat_mesh((4, 2), ("data", "model"), device_type="cpu")
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    sharded = distribute_tensor(w, mesh, placements(
        Sharding(mesh, ("data", "model"))))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(3, {"w": sharded})
    plan = plan_shrunk_mesh(mesh, n_failed=3)   # 2 a data rank: lose 2
    new_mesh = build_mesh_from_plan(plan, device_type="cpu")
    if new_mesh is None:
        return {"in_new_mesh": False}
    step, restored = mgr.restore(
        {"w": w}, shardings={"w": Sharding(new_mesh, ("data", "model"))},
        device="cpu")
    dt = restored["w"]
    return {"in_new_mesh": True, "step": step,
            "full": full_tensor(dt).numpy(), "local": dt.to_local().numpy(),
            "dtensor_full": dt.full_tensor().numpy(),
            "sizes": axis_sizes(dt.device_mesh),
            "plan": plan.new_shape}


def test_elastic_remesh_restore(tmp_path):
    """Checkpoint on a (4, 2) mesh of 8 ranks, lose 3 of them, restore
    onto the (2, 2) mesh of the first 4 (the JAX package's
    `test_elastic_remesh_restore`)."""
    out = run_ranks(_elastic_rank, 8, str(tmp_path), timeout=90)
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert [o["in_new_mesh"] for o in out] == [True] * 4 + [False] * 4
    for rank, o in enumerate(out[:4]):
        assert o["step"] == 3 and o["plan"] == {"data": 2, "model": 2}
        assert o["sizes"] == {"data": 2, "model": 2}
        np.testing.assert_array_equal(o["full"], w)
        np.testing.assert_array_equal(o["dtensor_full"], w)
        r, c = divmod(rank, 2)
        np.testing.assert_array_equal(o["local"],
                                      w[4 * r:4 * r + 4, 2 * c:2 * c + 2])


def _shrunk_save_rank(rank, world, ckpt_dir):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.elastic import (
        build_mesh_from_plan, plan_shrunk_mesh,
    )
    from repro_torch.launch.mesh import compat_mesh
    mesh = compat_mesh((2, 2), ("data", "model"), device_type="cpu")
    plan = plan_shrunk_mesh(mesh, n_failed=1)    # ranks 0, 1 lost
    new_mesh = build_mesh_from_plan(plan, ranks=[2, 3], device_type="cpu")
    if new_mesh is None:
        return {"in_new_mesh": False}
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    spec = Sharding(new_mesh, ("data", "model"))
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(5, {"w": distribute_tensor(w, new_mesh, placements(spec))})
    step, restored = mgr.restore({"w": w}, shardings={"w": spec},
                                 device="cpu")
    return {"in_new_mesh": True, "step": step,
            "local": restored["w"].to_local().numpy()}


def test_save_and_restore_on_a_shrunk_mesh_without_rank_0(tmp_path):
    """A (2, 2) mesh loses ranks 0 and 1; the (1, 2) mesh of ranks 2 and 3
    saves (its first rank, 2, writes) and restores, while the ranks left
    out take no part."""
    out = run_ranks(_shrunk_save_rank, 4, str(tmp_path), timeout=60)
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert [o["in_new_mesh"] for o in out] == [False, False, True, True]
    for c, o in enumerate(out[2:]):
        assert o["step"] == 5
        np.testing.assert_array_equal(o["local"], w[:, 2 * c:2 * c + 2])


def test_the_distributed_plane_loads_no_model_code():
    code = ("import sys, repro_torch.distributed, "
            "repro_torch.serving.cluster_service, repro_torch.checkpoint.wal;"
            "print([m for m in sys.modules "
            "if m.startswith('repro_torch.models')])")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
