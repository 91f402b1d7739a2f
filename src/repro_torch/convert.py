"""Carry state between the JAX package and the port, as numpy arrays.

The JAX `CenterPool` / `OCCStats` / `ModelSnapshot` / `HierIndex` fields
go through `np.asarray` on the JAX side; these functions take and give the
same fields, so a pass run by one package can be continued by the other
from the same pool, and the same published state can be served by both.
A language model's parameter tree (`jax.tree.map(np.asarray, params)`)
becomes a port `Model` (`lm_params_from_numpy`), and a port cache goes back
to the JAX layout (`lm_caches_to_numpy`), so both packages' models can be
run on the same weights and compared.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.occ import CenterPool, OCCStats
from repro_torch.models.model import Model, _seg_key
from repro_torch.models.transformer import segments_for
from repro_torch.serving.snapshot import HierIndex, ModelSnapshot

__all__ = ["pool_from_numpy", "pool_to_numpy", "stats_to_numpy",
           "snapshot_from_numpy", "hier_from_numpy", "lm_params_from_numpy",
           "lm_caches_to_numpy"]


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
                         dtype: str | None = None) -> Model:
    """A port `Model` of `cfg` on `device` holding the JAX package's
    parameters: `tree` is the JAX tree after `jax.tree.map(np.asarray,
    params)`, with `lm_head` (D, V) as the JAX package stores it (absent
    when the embeddings are tied) and each segment's leaves stacked on a
    leading layer dim (split here per layer).  `dtype` (a torch dtype name)
    overrides `cfg.dtype`."""
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    model = Model(cfg, device=device)

    def put(param, a):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(param.shape):
            raise ValueError(f"shape {a.shape} does not match the port's "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))

    put(model.tok_embed, tree["tok_embed"])
    put(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        put(model.lm_head, tree["lm_head"])
    for i, (_, count, _) in enumerate(segments_for(cfg)):
        stacked = tree["segments"][_seg_key(i)]
        layers = model.segments[_seg_key(i)]
        if set(stacked) != set(layers[0].keys()):
            raise ValueError(f"{_seg_key(i)}: JAX leaves {sorted(stacked)} "
                             f"!= port {sorted(layers[0].keys())}")
        for name, a in stacked.items():
            for layer in range(count):
                put(layers[layer][name], np.asarray(a)[layer])
    return model


def lm_caches_to_numpy(caches: dict) -> dict:
    """A port cache ({"seg_00": [{"k", "v"} per layer]}) in the JAX layout:
    {"seg_00": {"k": (L, B, S, Hkv, hd), "v": ...}} as f32 numpy arrays."""
    return {seg: {name: np.stack([c[name].detach().to(torch.float32)
                                  .cpu().numpy() for c in layers])
                  for name in layers[0]}
            for seg, layers in caches.items()}
