"""Import hygiene of the port: it never imports JAX or the JAX package.

An AST scan of every module of `src/repro_torch/` and of `chip_smoke.py`,
and a subprocess in which `jax` and `repro` cannot be imported at all that
imports the port, runs a tiny pass on the CPU (DP-means, OFL and
BP-means), publishes it and serves one top-k query from it, replicates it
over a loopback `DeltaChannel`, recovers it from a `DeltaWAL`, then builds
`reduced(qwen3-4b)` on the CPU, serves two requests through the
language model's `ServeEngine`, curates the embeddings of two token
batches, takes one train step of that model (the optimizer and the train
step) and one of `reduced(olmoe-1b-7b)` (the MoE block), and imports the train-while-serve and training launchers and every
example, then dry-runs a narrow granite-3-2b decode cell on the meta device
(`roofline`, `launch/specs`, `launch/dryrun`).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_port_runs_with_jax_and_repro_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch.convert, repro_torch.core._reference
from repro_torch.core import DPMeansTransaction, OCCEngine, occ_dp_means
from repro_torch.data import dp_stick_breaking_data
from repro_torch.kernels import _build
x = dp_stick_breaking_data(300, seed=0)[0]
from repro_torch.serving import ClusterService, SnapshotStore
store = SnapshotStore(hier=True, device="cpu")
res = OCCEngine(DPMeansTransaction(4.0, 64), 64, device="cpu",
                publish=store.publish_pass).run(x)
occ = occ_dp_means(x, 4.0, 64, k_max=64, max_iters=2, device="cpu")
assert 1 <= int(res.pool.count) < 64 and occ.z.shape == (300,)
from repro_torch.core import occ_bp_means, occ_ofl
from repro_torch.data import bp_stick_breaking_data
ofl = occ_ofl(x, 4.0, 64, key=(0, 1), k_max=128, device="cpu")
assert 1 <= int(ofl.pool.count) < 128 and ofl.z.shape == (300,)
xb = bp_stick_breaking_data(128, seed=0)[0]
bp = occ_bp_means(xb, 4.0, 32, k_max=32, max_iters=2, device="cpu")
assert 2 <= int(bp.pool.count) < 32 and bp.z.shape == (128, 32)
top = ClusterService(store, probes=1).topk(x[:5], k=2)
assert top.labels.shape == (5, 2) and top.version == 1
import tempfile
from repro_torch.checkpoint import DeltaWAL, WireTee, recover_wal
from repro_torch.distributed import DeltaChannel, make_follower, store_digest
chan = DeltaChannel()
wal_dir = tempfile.mkdtemp()
wal = DeltaWAL(wal_dir, model="m", fsync=False, device="cpu")
primary = SnapshotStore(delta=True, model="m", wire=WireTee(chan, wal),
                        device="cpu")
follower = make_follower(chan, "m", device="cpu")
OCCEngine(DPMeansTransaction(4.0, 64), 64, device="cpu").run_from_proposals(
    x, on_commit=lambda p, e, t: primary.publish_pool(p, epochs=e + 1))
assert chan.pump() == 5 and follower.versions() == [1, 2, 3, 4, 5]
wal.close()
recovered, _ = recover_wal(wal_dir, model="m", device="cpu")
assert store_digest(follower) == store_digest(recovered) \
    == store_digest(primary)
import torch
from repro_torch.configs import get_arch, reduced
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeEngine
cfg = reduced(get_arch("qwen3-4b")).replace(dtype="float32")
lm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
done = ServeEngine(lm, n_slots=2, cache_len=16).run(
    [Request(uid=i, prompt=np.arange(3) + i, max_new=2) for i in range(2)])
assert [len(r.out) for r in done] == [2, 2]
from repro_torch.data import TokenPipeline
from repro_torch.data.curation import curate, embed_sequences
emb = embed_sequences(lm, [TokenPipeline(cfg.vocab, 4, 8).batch_at(s)
                           for s in range(2)])
rep = curate(emb, lam=1.0, pb=4, k_max=8)
assert emb.shape == (8, cfg.d_model) and rep.n_points == 8
from repro_torch.configs import TrainConfig
from repro_torch.training import make_train_step, train_state_init
tc = TrainConfig(warmup_steps=1, total_steps=2)
st = train_state_init({n: p.detach() for n, p in lm.named_parameters()}, tc)
st, met = make_train_step(lm, tc)(st, TokenPipeline(cfg.vocab, 2, 8).batch_at(0))
assert int(met["step"]) == 1 and bool(torch.isfinite(met["loss"]))
moe_cfg = reduced(get_arch("olmoe-1b-7b")).replace(dtype="float32")
moe_lm = build_model(moe_cfg, device="cpu").init(torch.Generator().manual_seed(0))
st = train_state_init({n: p.detach() for n, p in moe_lm.named_parameters()}, tc)
st, met = make_train_step(moe_lm, tc)(st, TokenPipeline(moe_cfg.vocab, 2, 8).batch_at(0))
assert bool(torch.isfinite(met["loss"]))
import repro_torch.optim
from repro_torch.launch import serve_clusters, train
from repro_torch.examples import (
    crash_recovery, data_curation, observability, quickstart,
    retrieval_index, serve_lm, streaming_clusters, train_lm)
assert serve_clusters.ServeDemoConfig().device == "cuda"
from repro_torch import roofline
from repro_torch.launch import dryrun, specs
import contextlib, io
with contextlib.redirect_stdout(io.StringIO()):   # its one-line summary
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", variant=dict(
        n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128))
assert rec["status"] == "ok" and rec["n_chips"] == 1
assert roofline.HW["peak_flops"] == 989e12
assert not _build._LIBS   # the CPU path never builds or loads a kernel
print("OK", int(res.pool.count))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
