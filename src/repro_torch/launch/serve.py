"""Batched serving launcher of the port's language model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --reduced --device cpu --requests 8 --prompt-len 16 --max-new 16

Runs the slot-based ServeEngine (token-by-token prefill, decode loop, slot
recycling) on random weights from `--seed` and reports throughput.  The
device is the card unless `--device cpu` is passed; on the CPU the model
runs in float32, as the JAX launcher does on its CPU backend.

`--mesh single|multi` runs one process a rank, started by `torchrun` (its
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT; `launch.mesh.
init_ranks_from_env`), on `make_production_mesh` (too few ranks raise
torch's own error).  The weights are tensor-parallel over `model` and
replicated over the data axes (ZeRO-3 off: a decode step would otherwise
gather every weight), each data rank serves its rows of the slots, and
every rank prints the same tokens; rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed.shardings import shard_ctx
from repro_torch.launch.mesh import init_ranks_from_env, make_production_mesh
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--decode-mode", choices=["tp", "cp"], default="tp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    if dev.type == "cpu":
        arch = arch.replace(dtype="float32")

    mesh, show = None, True
    if args.mesh != "none":
        init_ranks_from_env(dev.type)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=dev.type)
        show = dist.get_rank() == 0
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    with shard_ctx(mesh, zero3=False):
        model = build_model(arch, device=dev, mesh=mesh).init(gen)
    engine = ServeEngine(model, n_slots=args.slots, cache_len=args.cache_len,
                         decode_mode=args.decode_mode)
    reqs = [Request(uid=i, prompt=rng.integers(0, arch.vocab, args.prompt_len),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    if show:
        print(f"served {len(done)} requests, {total_new} new tokens "
              f"in {dt:.2f}s ({total_new / max(dt, 1e-9):.1f} tok/s, "
              f"{args.slots} slots, {dev})")
        for r in done[:4]:
            print(f"  req {r.uid}: out[:8]={r.out[:8]}")
    return done


if __name__ == "__main__":
    main()
