"""Meta-device stand-ins for every dry-run cell (the port of
`repro/launch/specs.py`, for one card).

`input_specs(arch, shape)` gives the cell's model inputs as tensors on the
"meta" device (shapes and dtypes, no storage); `state_specs` and
`cache_specs` give a training state and decode caches the same way, and
`plan_cell` assembles the cell's function (an AdamW train step, `prefill`
or `decode_step`) with its meta arguments into a `CellPlan`, whose `run()`
executes it on them.  The JAX package's sharding specs
(`input_spec_shardings`, the PartitionSpec trees) wait for the language
model's half of the mesh: a mesh of more than one card raises.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, TrainConfig
from repro_torch.models.model import Model
from repro_torch.training.step import TrainState, make_train_step, train_state_init

__all__ = ["input_specs", "state_specs", "cache_specs", "pick_decode_mode",
           "CellPlan", "plan_cell", "multi_card"]

META = torch.device("meta")


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def multi_card(what: str) -> NotImplementedError:
    """The error raised where a mesh of more than one card is asked for."""
    return NotImplementedError(f"{what} waits for the multi-card slice of "
                               "the language model (ROADMAP.md queue 1)")


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Model-input stand-ins for one cell (no device allocation)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {
            "tokens": _sds((b, s), torch.int32),
            "labels": _sds((b, s), torch.int32),
        }
        if arch.frontend:
            specs["frontend"] = _sds((b, arch.frontend_len, arch.frontend_dim),
                                     torch.float32)
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs
    # decode: one new token against a cache of seq_len
    return {
        "tokens": _sds((b, 1), torch.int32),
        "pos": _sds((b,), torch.int32),
    }


def state_specs(model: Model, tcfg: TrainConfig) -> TrainState:
    """The TrainState (params + moments + error feedback) over a
    meta-device `model`'s parameters."""
    return train_state_init(
        {n: p.detach() for n, p in model.named_parameters()}, tcfg)


def pick_decode_mode(arch: ArchConfig, shape: ShapeConfig,
                     force_decode_mode: str | None = None) -> str:
    """"tp" on one card (the JAX package picks "cp" only where a model
    axis cannot shard the cache), unless forced."""
    return force_decode_mode or "tp"


def cache_specs(model: Model, shape: ShapeConfig) -> dict:
    """`model.init_cache` of the cell's batch and sequence, on the meta
    device of a meta `model`."""
    return model.init_cache(shape.global_batch, shape.seq_len)


class CellPlan:
    """Everything needed to run one (arch x shape) cell on meta tensors:
    `fn(*args)`, with `args` every tensor the cell takes (a training state,
    or the parameters and caches, and the batch)."""
    def __init__(self, fn, args, meta):
        self.fn = fn
        self.args = args
        self.meta = meta

    def run(self):
        return self.fn(*self.args)


def plan_cell(arch: ArchConfig, shape: ShapeConfig,
              mesh_shape: dict | None = None,
              tcfg: TrainConfig | None = None,
              force_decode_mode: str | None = None) -> CellPlan:
    if mesh_shape and math.prod(mesh_shape.values()) != 1:
        raise multi_card(f"the mesh {mesh_shape}")
    model = Model(arch, device=META)
    tcfg = tcfg or TrainConfig()
    meta: dict[str, Any] = {
        "arch": arch.name, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(mesh_shape or {}), "device": "meta",
    }

    if shape.kind == "train":
        state = state_specs(model, tcfg)
        train_step = make_train_step(model, tcfg)
        return CellPlan(train_step, (state, input_specs(arch, shape)), meta)

    # prefill and decode run the model's own parameters; they are passed
    # as an argument so that the plan's arguments hold every input tensor
    params = dict(model.named_parameters())
    mode = pick_decode_mode(arch, shape, force_decode_mode)
    meta["decode_mode"] = mode
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return model.prefill(batch)

        return CellPlan(prefill_fn, (params, input_specs(arch, shape)), meta)

    io = input_specs(arch, shape)

    def serve_step(params, caches, tokens, pos):
        return model.decode_step(caches, tokens, pos, decode_mode=mode)

    return CellPlan(serve_step, (params, cache_specs(model, shape),
                                 io["tokens"], io["pos"]), meta)
