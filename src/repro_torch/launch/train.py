"""End-to-end training launcher of the port's language model.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir <dir> --device cpu

The port of `repro/launch/train.py`: config registry -> model -> train
step -> token pipeline -> checkpoint manager -> watchdog, with the same
flags and printed lines.  The device is the card unless `--device cpu` is
passed; on the CPU the model runs in float32, as the JAX launcher does on
its CPU backend.  For the frontend families (internvl2-2b,
seamless-m4t-medium) each step's batch adds stub embeddings under
"frontend", drawn from (seed, step) as the JAX launcher draws them.  A checkpoint holds the training state in the JAX
package's layout (`convert.train_state_to_numpy`), so either package's
launcher resumes the other's.  Returns the final loss.

`--mesh single|multi` runs one process a rank, started by `torchrun` (its
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT; `launch.mesh.
init_ranks_from_env`), on `make_production_mesh` (too few ranks raise
torch's own error): the sharded train step (`training/step.py`) over a
model whose parameters are DTensors of each rank's blocks.  Its
checkpoints are the same JAX-layout state, gathered whole on every rank
and written by rank 0; `--resume` puts each rank's blocks back as
DTensors (`convert.train_state_from_numpy(mesh=)`).  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.fault import StepWatchdog
from repro_torch.distributed.shardings import shard_ctx
from repro_torch.launch.mesh import init_ranks_from_env, make_production_mesh
from repro_torch.models import build_model
from repro_torch.training.step import make_train_step, train_state_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    if args.dtype:
        arch = arch.replace(dtype=args.dtype)
    elif dev.type == "cpu":
        arch = arch.replace(dtype="float32")

    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=max(2, args.steps // 10),
                       total_steps=args.steps, microbatches=args.microbatches,
                       seed=args.seed)
    mesh, show = None, True
    if args.mesh != "none":
        init_ranks_from_env(dev.type)
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=dev.type)
        show = dist.get_rank() == 0
    with shard_ctx(mesh):
        model = build_model(arch, device=dev, mesh=mesh)
    pipe = TokenPipeline(arch.vocab, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    watchdog = StepWatchdog()

    def save(step):
        tree = train_state_to_numpy(state)      # on a mesh, every rank
        if show:
            ckpt.save(step, tree)
            ckpt.wait()
        if mesh is not None:
            dist.barrier()

    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    state = train_state_init(
        {n: p.detach() for n, p in model.named_parameters()}, tcfg)
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start_step, tree = ckpt.restore(train_state_to_numpy(state),
                                        device="cpu")
        with shard_ctx(mesh):
            state = train_state_from_numpy(tree, arch, device=dev, mesh=mesh)
        if show:
            print(f"resumed from step {start_step}")
    step_fn = make_train_step(model, tcfg)

    n_params = model.param_count()
    if show:
        print(f"arch={arch.name} params={n_params:,} steps={args.steps} "
              f"batch={args.batch} seq={args.seq}")
    t_start = time.time()
    loss = float("nan")
    for step in range(start_step, args.steps):
        batch = pipe.batch_at(step)
        if arch.frontend:
            # the frontend families' stub embeddings, drawn as the JAX
            # launcher draws them
            rng = np.random.default_rng([args.seed, step])
            batch["frontend"] = rng.normal(
                size=(args.batch, arch.frontend_len, arch.frontend_dim)
            ).astype(np.float32)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        ev = watchdog.observe(step, dt)
        if ev and show:
            print(f"[straggler] step {step}: {dt:.2f}s vs ewma {ev.ewma:.2f}s")
        if show and (step % args.log_every == 0 or step == args.steps - 1):
            toks = args.batch * args.seq
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt:6.2f}s "
                  f"({toks / max(dt, 1e-9):,.0f} tok/s)")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if ckpt:
        save(args.steps)
    if show:
        print(f"done in {time.time() - t_start:.1f}s; final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
