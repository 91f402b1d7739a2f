"""Carry state between the JAX package and the port, as numpy arrays.

The JAX `CenterPool` / `OCCStats` / `ModelSnapshot` / `HierIndex` fields
go through `np.asarray` on the JAX side; these functions take and give the
same fields, so a pass run by one package can be continued by the other
from the same pool, and the same published state can be served by both.
A language model's parameter tree (`jax.tree.map(np.asarray, params)`)
becomes a port `Model` (`lm_params_from_numpy`), and a port cache goes back
to the JAX layout (`lm_caches_to_numpy`), so both packages' models can be
run on the same weights and compared.  A training state goes both ways
(`train_state_from_numpy`, `train_state_to_numpy`): the JAX package's
`TrainState` (params, AdamW step / mu / nu, error-feedback residuals, each
segment's and the encoder's leaves stacked on a leading layer dim) and the
port's (tensors
keyed by the port's parameter names), so a state saved by either package's
`CheckpointManager` restores in the other under the JAX package's leaf
names.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.occ import CenterPool, OCCStats
from repro_torch.distributed.shardings import (
    full_tensor, is_dtensor, like_dtensor, shard_block,
)
from repro_torch.models.model import (
    Model, _seg_key, layer_of, stacked_segments,
)
from repro_torch.models.transformer import segments_for
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compression import EFState
from repro_torch.serving.snapshot import HierIndex, ModelSnapshot
from repro_torch.training.step import TrainState

__all__ = ["pool_from_numpy", "pool_to_numpy", "stats_to_numpy",
           "snapshot_from_numpy", "hier_from_numpy", "lm_params_from_numpy",
           "lm_caches_to_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]


def pool_from_numpy(centers, mask, count, overflow,
                    device: str | torch.device = "cuda") -> CenterPool:
    """The port's `CenterPool` on `device` from the JAX pool's fields:
    centers (K_max, D), mask (K_max,) bool, count () int32, overflow ()
    bool."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype=dtype), device=dev)
    centers = np.asarray(centers)
    return CenterPool(t(centers, centers.dtype), t(mask, np.bool_),
                      t(count, np.int32), t(overflow, np.bool_))


def pool_to_numpy(pool: CenterPool) -> dict[str, np.ndarray]:
    """The pool's fields as numpy arrays, keyed by field name."""
    return {k: v.detach().cpu().numpy() for k, v in pool._asdict().items()}


def stats_to_numpy(stats: OCCStats) -> dict[str, np.ndarray | None]:
    """The stats' fields as numpy arrays (cap may be None)."""
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in stats._asdict().items()}


def hier_from_numpy(coarse, coarse_mask, fine, fine_ids, fine_mask, n_cells,
                    shard_cap, device: str | torch.device = "cuda"
                    ) -> HierIndex:
    """The port's `HierIndex` on `device` from the JAX index's fields."""
    dev = resolve_device(device)

    def t(a, dtype=None):
        a = np.array(a) if dtype is None else np.array(a, dtype=dtype)
        return torch.as_tensor(a, device=dev)
    return HierIndex(coarse=t(coarse), coarse_mask=t(coarse_mask, np.bool_),
                     fine=t(fine), fine_ids=t(fine_ids, np.int32),
                     fine_mask=t(fine_mask, np.bool_), n_cells=int(n_cells),
                     shard_cap=int(shard_cap))


def snapshot_from_numpy(version, centers, mask, count, capacity, *,
                        hier: dict | None = None,
                        device: str | torch.device = "cuda",
                        **meta) -> ModelSnapshot:
    """The port's `ModelSnapshot` on `device` from the JAX snapshot's
    fields: centers (capacity, D), mask (capacity,) bool, the host ints,
    `hier` as a dict of `HierIndex` fields (or None) and the remaining
    scalar metadata (n_seen, epochs, overflow, objective, cap_est,
    cap_trace) as keywords."""
    dev = resolve_device(device)
    centers = np.array(centers)
    return ModelSnapshot(
        version=int(version), centers=torch.as_tensor(centers, device=dev),
        mask=torch.as_tensor(np.array(mask, dtype=np.bool_), device=dev),
        count=int(count), capacity=int(capacity),
        hier=None if hier is None else hier_from_numpy(**hier, device=dev),
        **meta)


def lm_params_from_numpy(tree: dict, cfg, device: str | torch.device = "cuda",
                         dtype: str | None = None, mesh=None) -> Model:
    """A port `Model` of `cfg` on `device` holding the JAX package's
    parameters: `tree` is the JAX tree after `jax.tree.map(np.asarray,
    params)`, with `lm_head` (D, V) as the JAX package stores it (absent
    when the embeddings are tied) and each segment's leaves stacked on a
    leading layer dim (split here per layer; a segment of one layer is not
    stacked), the hybrid family's shared block under "shared", the
    frontend's projector under "frontend" and the encoder under "encoder"
    ({"segments": {leaf: (enc_layers, ...)}, "norm": (D,)}).  The f32
    leaves (the MoE router, Mamba's a_log, dt_bias and d_skip) stay f32 in
    a bf16 model.  `dtype` (a torch dtype name) overrides `cfg.dtype`.
    `mesh`: a model on the mesh, each rank keeping its blocks
    (`Model.put`)."""
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = Model(cfg, device=device, mesh=mesh)

    def put(param, a):
        a = _np(a)
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"shape {a.shape} does not match the port's "
                             f"{tuple(param.shape)}")
        Model.put(param, torch.from_numpy(np.array(a, dtype=np.float32)))

    put(model.tok_embed, tree["tok_embed"])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])

    def fill(where, block, leaves, layer=None):
        if set(leaves) != set(block.keys()):
            raise ValueError(f"{where}: JAX leaves {sorted(leaves)} "
                             f"!= port {sorted(block.keys())}")
        for name, a in leaves.items():
            put(block[name], _np(a) if layer is None else _np(a)[layer])

    for i, (_, count, shared) in enumerate(segments_for(cfg)):
        if shared:
            continue
        layers = model.segments[_seg_key(i)]
        for layer in range(count):
            fill(_seg_key(i), layers[layer], tree["segments"][_seg_key(i)],
                 None if count == 1 else layer)
    if model.shared is not None:
        fill("shared", model.shared, tree["shared"])
    if model.frontend is not None:
        fill("frontend", model.frontend, tree["frontend"])
    if model.encoder is not None:
        for layer, block in enumerate(model.encoder.segments):
            fill("encoder", block, tree["encoder"]["segments"], layer)
        put(model.encoder.norm, tree["encoder"]["norm"])
    return model


def lm_caches_to_numpy(caches: dict) -> dict:
    """A port cache ({"seg_00": [cache per layer]}) in the JAX layout, each
    leaf stacked over the segment's layers (a shared or one-layer segment
    with a leading dim of 1): {"seg_00": {"k": (L, B, S, Hkv, hd), "v":
    ...}} for attention (and "ck", "cv" (L, B, F, Hkv, hd) for a decoder
    block), {"conv": (L, B, w-1, d_inner), "ssm": (L, B, H, hd, N)} for
    Mamba, and the mLSTM's and sLSTM's states, as f32 numpy arrays."""
    return {seg: {name: np.stack([c[name].detach().to(torch.float32)
                                  .cpu().numpy() for c in layers])
                  for name in layers[0]}
            for seg, layers in caches.items()}


def _np(a) -> np.ndarray:
    """A leaf (numpy array, tensor on any device, scalar) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _path(tree: dict, name: str, sep: str = "."):
    """The node of a nested tree at a dotted parameter name ("shared.wq"
    -> tree["shared"]["wq"]), or at a path with another separator."""
    for part in name.split(sep):
        tree = tree[part]
    return tree


def _from_jax_layout(tree: dict, names, device) -> dict[str, torch.Tensor]:
    """Per-name f32 tensors on `device` from a JAX-layout tree (a stack's
    leaves (`layer_of`) stacked over its layers when the JAX package
    stacks them; the shared block's under "shared")."""
    stacked = stacked_segments(names)
    out = {}
    for n in names:
        at = layer_of(n)
        if at is None:
            a = _np(_path(tree, n))
        else:
            a = _np(_path(tree, at[0], "/")[at[2]])
            a = a[at[1]] if at[0] in stacked else a
        out[n] = torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return out


def _to_jax_layout(named: dict[str, torch.Tensor]) -> dict:
    """The JAX-layout numpy tree of per-name tensors: each stack's layers
    stacked in layer order (a segment of one layer as it is), the shared
    block's under "shared", the encoder's under "encoder/segments";
    bfloat16 widened to f32 (exact; numpy has no bfloat16).  A DTensor is
    gathered whole first (a collective of its mesh, in the names' order on
    every rank)."""
    def host(t):
        if is_dtensor(t):
            t = full_tensor(t)
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()
    tree: dict = {}
    stacks: dict = {}
    for n, t in named.items():
        at = layer_of(n)
        if at is None:
            *outer, leaf = n.split(".")
            node = tree
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = host(t)
        else:
            stacks.setdefault(at[0], {}).setdefault(at[2], {})[at[1]] = t
    stacked = stacked_segments(named)
    for stack, leaves in stacks.items():
        node = tree
        for part in stack.split("/"):
            node = node.setdefault(part, {})
        for leaf, layers in leaves.items():
            node[leaf] = (np.stack([host(layers[i]) for i in sorted(layers)])
                          if stack in stacked else host(layers[0]))
    return tree


def train_state_from_numpy(tree, cfg, device: str | torch.device = "cuda",
                           mesh=None) -> TrainState:
    """The port's `TrainState` on `device` from a JAX-layout training state:
    the JAX package's `TrainState` after `jax.tree.map(np.asarray, state)`,
    or the tree a `CheckpointManager` restores into the structure of
    `train_state_to_numpy` (numpy arrays or tensors).  Parameters in
    cfg.dtype through `lm_params_from_numpy`; moments and residuals f32;
    the step int32.  `mesh`: the state of a model on the mesh, each
    rank's blocks (DTensors placed as the model's parameters)."""
    model = lm_params_from_numpy(tree.params, cfg, device=device, mesh=mesh)
    params = {n: p.detach() for n, p in model.named_parameters()}
    dev = model.device

    def placed(named):
        if mesh is None:
            return named
        return {n: like_dtensor(shard_block(
            t, mesh, params[n].placements).contiguous(), params[n])
            for n, t in named.items()}
    opt = AdamWState(
        step=torch.as_tensor(np.array(_np(tree.opt.step), dtype=np.int32),
                         device=dev),
        mu=placed(_from_jax_layout(tree.opt.mu, params, dev)),
        nu=placed(_from_jax_layout(tree.opt.nu, params, dev)))
    ef = tree.ef
    if isinstance(ef, tuple) and hasattr(ef, "residual"):
        ef = EFState(placed(_from_jax_layout(ef.residual, params, dev)))
    else:
        ef = ()
    return TrainState(params, opt, ef)


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's `TrainState` in the JAX package's layout, as numpy: the
    same NamedTuples (`TrainState`, `AdamWState`, `EFState`; their field
    names are the JAX package's) over JAX-layout trees, so a
    `CheckpointManager` of either package saves it under the JAX package's
    leaf names.  A mesh state is gathered whole on every rank of its mesh
    (each rank must call it)."""
    ef = state.ef
    if isinstance(ef, EFState):
        ef = EFState(_to_jax_layout(ef.residual))
    return TrainState(
        params=_to_jax_layout(state.params),
        opt=AdamWState(step=np.asarray(_np(state.opt.step), dtype=np.int32),
                       mu=_to_jax_layout(state.opt.mu),
                       nu=_to_jax_layout(state.opt.nu)),
        ef=ef)
