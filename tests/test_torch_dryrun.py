"""The port's dry run (`repro_torch.launch.specs`, `launch.dryrun`) on the
meta device, on the CPU.

  * `run_cell` for one arch of each family (dense, MoE, hybrid, xLSTM,
    vision prefix, encoder-decoder) and each kind (train, prefill,
    decode), at the reduced widths and depths (`reduced()` as a variant)
    and a short sequence: the record's keys, `n_chips` 1, `argument_bytes`
    equal to the bytes of a meta state built here (parameters, AdamW
    moments, step and batch; or parameters, caches and inputs), a peak at
    least the arguments, zero collective bytes, the analytic FLOPs and
    bytes and the roofline terms of `repro_torch.roofline`;
  * the MoE `ragged` impl on meta: an even split of the rows stands in for
    the routing, whose FLOPs equal those of a real routing on the CPU;
  * a `supports_shape` skip, the "multi-card" refusals, the CLI's record
    and `--skip-existing`, and that importing the module leaves
    `os.environ` as it was;
  * `MemTracker`'s high-water mark on meta tensors against a hand count.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import roofline  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ShapeConfig, TrainConfig, get_arch, reduced,
)
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.transformer import segments_for  # noqa: E402
from repro_torch.training import train_state_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["granite-3-2b", "olmoe-1b-7b", "zamba2-7b", "xlstm-1.3b",
            "internvl2-2b", "seamless-m4t-medium"]
KINDS = {"train": ShapeConfig("t_2x32", 32, 2, "train"),
         "prefill": ShapeConfig("p_2x32", 32, 2, "prefill"),
         "decode": ShapeConfig("d_2x32", 32, 2, "decode")}
RECORD_KEYS = {"cell", "status", "arch", "shape", "multi_pod", "variant",
               "meta", "n_chips", "n_params", "n_active", "memory", "cost",
               "collectives", "roofline", "model_flops_global",
               "model_flops_per_dev", "useful_flops_ratio", "timings"}


def _reduced_variant(name: str) -> dict:
    """`reduced(arch)` as a dry-run variant: every ArchConfig field it
    changes (the MoE's experts stay the config's)."""
    full, small = get_arch(name), reduced(get_arch(name))
    return {k: getattr(small, k) for k in full.__dataclass_fields__
            if k != "moe" and getattr(small, k) != getattr(full, k)}


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _expected_args(cfg, shape) -> list[int]:
    """The bytes of each argument of the cell, from tensors built here."""
    m = Model(cfg, device="meta")
    b, s = shape.global_batch, shape.seq_len
    batch = 4 * b * s * (1 if shape.kind == "prefill" else 2)
    if cfg.frontend and shape.kind != "decode":
        batch += 4 * b * cfg.frontend_len * cfg.frontend_dim
    if shape.kind == "train":
        st = train_state_init({n: p.detach() for n, p in
                               m.named_parameters()}, TrainConfig())
        state = _nbytes(list(st.params.values()) + list(st.opt.mu.values())
                        + list(st.opt.nu.values()) + [st.opt.step])
        return [state, batch]
    params = _nbytes(m.parameters())
    if shape.kind == "prefill":
        return [params, batch]
    caches = _nbytes(t for layers in m.init_cache(b, s).values()
                     for c in layers for t in c.values())
    return [params, caches, 4 * b, 4 * b]


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", FAMILIES)
def test_run_cell_on_meta(name, kind):
    shape = KINDS[kind]
    variant = _reduced_variant(name)
    rec = dryrun.run_cell(name, shape, variant=variant)
    assert set(rec) == RECORD_KEYS and rec["status"] == "ok"
    assert rec["n_chips"] == 1 and rec["meta"]["device"] == "meta"
    assert rec["meta"]["kind"] == kind and rec["variant"] == variant
    cfg = dryrun._apply_variant(get_arch(name), variant)
    mem = rec["memory"]
    assert mem["argument_bytes_each"] == _expected_args(cfg, shape)
    assert mem["argument_bytes"] == sum(mem["argument_bytes_each"])
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert mem["fits"] is True and mem["card_bytes"] == roofline.HBM_BYTES
    n = Model(cfg, device="meta").param_count()
    assert rec["n_params"] == n
    assert rec["n_active"] == roofline.active_params(cfg, n)
    segs = segments_for(cfg)
    cost = rec["cost"]
    assert cost["analytic_flops"] == roofline.analytic_flops(cfg, shape, segs)
    assert cost["analytic_bytes"] == roofline.analytic_bytes(cfg, shape, segs,
                                                             {}, n)
    assert cost["meta_flops"] > 0
    assert rec["collectives"]["total_bytes_scaled"] == 0
    assert rec["roofline"] == roofline.roofline_terms(
        cost["analytic_flops"]["step_total"], cost["analytic_bytes"]["total"],
        0.0)
    assert rec["model_flops_global"] == roofline.model_flops(
        cfg, shape, n, rec["n_active"])
    assert set(rec["timings"]) == {"plan_s", "run_s"}


def test_ragged_moe_on_meta_counts_the_routed_flops():
    variant = dict(_reduced_variant("olmoe-1b-7b"), moe_impl="ragged")
    shape = KINDS["prefill"]
    rec = dryrun.run_cell("olmoe-1b-7b", shape, variant=variant)
    assert rec["status"] == "ok" and "moe_group_sizes" in rec["meta"]
    # the same prefill on the CPU routes for real: the grouped products'
    # FLOPs depend only on the T·k rows
    cfg = dryrun._apply_variant(get_arch("olmoe-1b-7b"), variant).replace(
        dtype="float32")
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len))
    _, flops = roofline.meta_flop_count(m.prefill, {"tokens": toks})
    assert flops == rec["cost"]["meta_flops"]


def test_supports_shape_skip_and_multi_card_refusals(tmp_path):
    rec = dryrun.run_cell("granite-3-2b", "long_500k", out_dir=str(tmp_path))
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert len(list(tmp_path.iterdir())) == 1
    with pytest.raises(NotImplementedError, match="multi-card"):
        dryrun.run_cell("granite-3-2b", "train_4k", multi_pod=True)
    with pytest.raises(NotImplementedError, match="multi-card"):
        dryrun.run_cell("granite-3-2b", "train_4k",
                        variant={"mesh_shape": [16, 16]})
    for flag in ("--multi-pod", "--both-meshes"):
        with pytest.raises(NotImplementedError, match="multi-card"):
            dryrun.main(["--all", flag, "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="multi-card"):
        specs.plan_cell(get_arch("granite-3-2b"), KINDS["train"],
                        mesh_shape={"data": 16, "model": 16})
    plan = specs.plan_cell(get_arch("granite-3-2b"), KINDS["decode"],
                           mesh_shape={"data": 1})
    assert plan.meta["decode_mode"] == "tp"


def test_specs_stand_ins():
    cfg = get_arch("internvl2-2b")
    io = specs.input_specs(cfg, KINDS["train"])
    assert sorted(io) == ["frontend", "labels", "tokens"]
    assert io["frontend"].shape == (2, cfg.frontend_len, cfg.frontend_dim)
    assert all(t.device.type == "meta" for t in io.values())
    assert sorted(specs.input_specs(cfg, KINDS["prefill"])) == [
        "frontend", "tokens"]
    dec = specs.input_specs(cfg, KINDS["decode"])
    assert dec["tokens"].shape == (2, 1) and dec["pos"].shape == (2,)
    assert dec["tokens"].dtype == torch.int32
    assert specs.pick_decode_mode(cfg, KINDS["decode"]) == "tp"
    assert specs.pick_decode_mode(cfg, KINDS["decode"], "cp") == "cp"
    plan = specs.plan_cell(reduced(cfg), KINDS["decode"],
                           force_decode_mode="cp")
    assert plan.meta["decode_mode"] == "cp"
    logits, caches = plan.run()
    assert logits.shape == (2, reduced(cfg).vocab)
    assert logits.device.type == "meta" and caches is plan.args[1]


def test_cli_writes_records_and_skips_existing(tmp_path, capsys):
    argv = ["--arch", "qwen3-4b", "--shape", "decode_32k", "--out",
            str(tmp_path), "--variant",
            json.dumps(_reduced_variant("qwen3-4b"))]
    dryrun.main(argv)
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    rec = json.loads(files[0].read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 1
    assert isinstance(rec["memory"]["fits"], bool)
    capsys.readouterr()
    dryrun.main(argv + ["--skip-existing"])
    assert "[cached]" in capsys.readouterr().out


def test_import_leaves_environment_unchanged():
    code = ("import os\nbefore = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.specs\n"
            "import repro_torch.roofline\n"
            "assert dict(os.environ) == before\nprint('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def test_mem_tracker_high_water_on_meta():
    """What the dry run's peak is: the live bytes after each op, storages
    freed when their last tensor goes, arguments registered beforehand."""
    from torch.distributed._tools.mem_tracker import MemTracker
    a = torch.empty((1000,), device="meta")
    tracker = MemTracker()
    tracker.track_external(a)
    with tracker:
        b = a * 2                                     # a, b live: 8,000
        c = torch.empty((500, 1000), device="meta")   # + 2,000,000
        d = c @ torch.empty((1000, 10), device="meta")  # + 40,000 + 20,000
        del b, c, d
        e = torch.empty((100,), device="meta")        # a, e: 4,400
    peak = tracker.get_tracker_snapshot("peak")[torch.device("meta")]
    now = tracker.get_tracker_snapshot()[torch.device("meta")]
    assert peak["Total"] == 4_000 + 4_000 + 2_000_000 + 40_000 + 20_000
    assert now["Total"] == 4_000 + 400
    del e
