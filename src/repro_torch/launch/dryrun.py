"""Dry run of every (arch x shape) cell for one card, on the meta device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]

The port of `repro/launch/dryrun.py`.  Each cell's function (an AdamW train
step, `prefill` or `decode_step`) runs once on meta tensors (`launch/specs`):
shapes and dtypes flow through the port's own code and nothing is computed
or allocated, so it needs no card.  Each cell emits a JSON record with the
memory the card must hold (arguments and outputs exact from the tensors'
sizes; the peak from the live-bytes high-water mark of the meta run, which
`MemTracker` follows storage by storage), the meta run's FLOP count beside
the analytic model's FLOPs and bytes (`roofline.py`), zero collective bytes
(one card) and the roofline terms at the H100's constants.  A cell whose
peak exceeds the card's memory is a record with `fits: false`, not a
failure; a failure here (a shape mismatch, an op without a meta kernel) is a
bug in the port.

What the meta run counts is the plain versions': on the meta device every
kernel takes its plain version (`kernels/ops`), and `attn_impl="flash"` the
chunked attention (`models/attention.attention_train` launches flash only
on a CUDA tensor), which forms a (B, Hkv, g, chunk, S) f32 block of logits
that the kernel never writes.  The MoE `ragged` impl's group sizes depend on
the routing, which meta tensors do not hold; there the run takes an even
split of the same T·k rows (`models/moe._group_sizes`), which gives the
same FLOPs and bytes as any routing.  Importing this module has no side
effect.  Meshes (`--multi-pod`, `--both-meshes`, a `mesh_shape` variant)
wait for the multi-card slice and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import roofline
from repro_torch.configs import (
    ARCHS, SHAPES, ShapeConfig, TrainConfig, get_arch, supports_shape,
)
from repro_torch.launch.specs import META, multi_card, plan_cell
from repro_torch.models.model import Model
from repro_torch.models.transformer import segments_for

__all__ = ["run_cell", "main"]

DEFAULT_OUT = "results/dryrun_torch"


def _tensors(tree):
    """The distinct tensors of a tree of dicts, lists and tuples."""
    seen, out, stack = set(), [], [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            if id(node) not in seen:
                seen.add(id(node))
                out.append(node)
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _apply_variant(arch, variant: dict):
    arch = arch.replace(**{k: v for k, v in variant.items()
                           if k in arch.__dataclass_fields__ and k != "moe"})
    if "moe_impl" in variant and arch.moe is not None:
        arch = arch.replace(
            moe=dataclasses.replace(arch.moe, impl=variant["moe_impl"]))
    if "capacity_factor" in variant and arch.moe is not None:
        arch = arch.replace(moe=dataclasses.replace(
            arch.moe, capacity_factor=variant["capacity_factor"]))
    return arch


def run_cell(arch_name: str, shape: str | ShapeConfig, multi_pod: bool = False,
             variant: dict | None = None, out_dir: str | None = None) -> dict:
    """Plan and run one cell on the meta device -> its record (also written
    under `out_dir` when given).  `shape` is a name of `SHAPES` or a
    `ShapeConfig` of its own (a cut batch, say)."""
    if multi_pod:
        raise multi_card("the multi-pod mesh")
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    arch = get_arch(arch_name)
    ok, why = supports_shape(arch, shape)
    label = f"{arch_name} x {shape.name} x 1 card"
    variant = variant or {}
    if not ok:
        rec = {"cell": label, "status": "skipped", "reason": why,
               "arch": arch_name, "shape": shape.name, "multi_pod": False}
        _emit(rec, out_dir, arch_name, shape.name, variant)
        print(f"[skip] {label}: {why}")
        return rec

    if "mesh_shape" in variant:
        raise multi_card("a mesh_shape variant")
    arch = _apply_variant(arch, variant)
    tcfg = TrainConfig(microbatches=int(variant.get("microbatches", 1)))
    t0 = time.perf_counter()
    plan = plan_cell(arch, shape, None, tcfg,
                     force_decode_mode=variant.get("force_decode_mode"))
    args = _tensors(plan.args)
    t_plan = time.perf_counter() - t0

    from torch.distributed._tools.mem_tracker import MemTracker
    tracker = MemTracker()
    tracker.track_external(*args)
    t0 = time.perf_counter()
    with tracker:
        out, meta_flops = roofline.meta_flop_count(plan.run)
    t_run = time.perf_counter() - t0
    peak = tracker.get_tracker_snapshot("peak")[META]["Total"]
    outs = _tensors(out)
    arg_ids = {id(t) for t in args}
    arg_bytes = _nbytes(args)
    fresh_out = _nbytes(t for t in outs if id(t) not in arg_ids)

    n_params = Model(arch, device=META).param_count()
    n_active = roofline.active_params(arch, n_params)
    segs = segments_for(arch)
    ana_f = roofline.analytic_flops(arch, shape, segs)
    ana_b = roofline.analytic_bytes(arch, shape, segs, {}, n_params)
    flops_dev = ana_f["step_total"]
    bytes_dev = ana_b["total"]
    terms = roofline.roofline_terms(flops_dev, bytes_dev, 0.0)
    mf = roofline.model_flops(arch, shape, n_params, n_active)
    meta = dict(plan.meta, counted_on="the plain versions (meta device)")
    if arch.moe is not None and arch.moe.impl == "ragged":
        meta["moe_group_sizes"] = "even split of the T·k rows (meta stand-in)"

    rec = {
        "cell": label, "status": "ok",
        "arch": arch_name, "shape": shape.name, "multi_pod": False,
        "variant": variant, "meta": meta,
        "n_chips": 1, "n_params": n_params, "n_active": n_active,
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_bytes_each": [_nbytes(_tensors(a)) for a in plan.args],
            "output_bytes": _nbytes(outs),
            # what the high-water mark holds beyond the arguments and the
            # outputs that are not arguments (XLA's peak = args + out + temp)
            "temp_bytes": max(0, peak - arg_bytes - fresh_out),
            "peak_bytes": peak,
            "card_bytes": roofline.HBM_BYTES,
            "fits": peak <= roofline.HBM_BYTES,
        },
        "cost": {
            "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
            "meta_flops": float(meta_flops),
            "analytic_flops": ana_f, "analytic_bytes": ana_b,
        },
        "collectives": {"bytes_by_kind_scaled": {}, "count_by_kind": {},
                        "total_bytes_scaled": 0},
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": mf / flops_dev if flops_dev else None,
        "timings": {"plan_s": t_plan, "run_s": t_run},
    }
    _emit(rec, out_dir, arch_name, shape.name, variant)
    print(f"[ok] {label}: dominant={terms['dominant']} "
          f"compute={terms['compute_s']:.4f}s memory={terms['memory_s']:.4f}s "
          f"peak={peak / 1e9:.2f}GB fits={rec['memory']['fits']} "
          f"useful={rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)} "
          f"(run {t_run:.1f}s)")
    return rec


def _record_path(out_dir, arch_name, shape_name, variant) -> str:
    vtag = ("__" + "_".join(f"{k}-{v}" for k, v in sorted(variant.items()))) \
        if variant else ""
    fname = f"{arch_name}__{shape_name}__1card{vtag}.json"
    return os.path.join(out_dir, fname.replace("/", "-"))


def _emit(rec, out_dir, arch_name, shape_name, variant):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(_record_path(out_dir, arch_name, shape_name, variant), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--variant", default=None,
                    help="JSON dict of ArchConfig / TrainConfig overrides")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.multi_pod or args.both_meshes:
        raise multi_card("--multi-pod / --both-meshes")
    variant = json.loads(args.variant) if args.variant else {}
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    t0 = time.perf_counter()
    for a, s in cells:
        if args.skip_existing and args.out \
                and os.path.exists(_record_path(args.out, a, s, variant)):
            print(f"[cached] {a} x {s} x 1 card")
            continue
        try:
            run_cell(a, s, False, variant, args.out)
        except Exception as e:
            failures.append((a, s, repr(e)))
            print(f"[FAIL] {a} x {s} x 1 card: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall cells OK ({time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    main()
