"""Sharding rules: how the OCC engine's epochs, the serving plane's queries
and every model parameter map onto the mesh.  The port of
`repro/distributed/shardings.py`.

Axes: `pod` (cross-pod data parallelism), `data` (in-pod data parallelism
and ZeRO-3 weight sharding), `model` (tensor parallelism; context
parallelism for long KV caches).

A spec is a per-dimension tuple whose elements are an axis name, a tuple
of axis names or None (the JAX package's `PartitionSpec`); a `Sharding`
is a (mesh, spec) pair (its `NamedSharding`), and `placements` turns one
into DTensor placements, `Shard(d)` or `Replicate()` for each mesh
dimension.  Every helper is divisibility-aware: an axis is used only when
it evenly divides the dimension, so kv_heads=8 on a 16-way model axis
falls back to replication and a width-1 epoch is proposed on every rank.

The port runs one process per rank, so what the JAX package states as a
placement the port carries out: `axis_shard` gives this rank's block of a
dimension split over one axis, and `gather_rows` assembles the blocks of
every rank, in group-rank order, on every rank (the replicated result);
`full_tensor` gathers a DTensor whole the same way.
`constrain` and `res_constrain` come with their callers in the model code,
in the language model's half of the mesh; `compat_shard_map` has no
counterpart: the port's per-rank code is the body a shard_map would run.
"""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.occ import tree_leaves, tree_unflatten
from repro_torch.launch.mesh import axis_sizes

__all__ = ["ShardCtx", "shard_ctx", "current_ctx", "batch_spec",
           "param_specs", "input_shardings", "axes_that_divide", "spec_for",
           "Sharding", "placements", "occ_epoch_sharding",
           "occ_validate_sharding", "serve_snapshot_sharding",
           "serve_query_sharding", "AxisShard", "axis_shard", "gather_rows",
           "full_tensor"]


@dataclass
class ShardCtx:
    mesh: Any = None
    data_axes: tuple[str, ...] = ("pod", "data")   # axes used for batch DP
    model_axis: str = "model"
    seq_shard_acts: bool = False      # sequence-parallel activations
    zero3: bool = True                # shard weights over data axes too
    cp_decode_axes: tuple[str, ...] = ("model",)   # KV-cache CP axes
    force_decode_mode: str | None = None           # override tp/cp choice

    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return axis_sizes(self.mesh).get(name, 1)

    @property
    def present_data_axes(self) -> tuple[str, ...]:
        if self.mesh is None:
            return ()
        sizes = axis_sizes(self.mesh)
        return tuple(a for a in self.data_axes if a in sizes)


_CTX = ShardCtx()


@contextlib.contextmanager
def shard_ctx(mesh, **kw):
    """Install a sharding context; code reads it via current_ctx()."""
    global _CTX
    prev = _CTX
    _CTX = ShardCtx(mesh=mesh, **kw)
    try:
        yield _CTX
    finally:
        _CTX = prev


def current_ctx() -> ShardCtx:
    return _CTX


def axes_that_divide(dim: int, axes: tuple[str, ...],
                     ctx: ShardCtx) -> tuple[str, ...]:
    """Largest prefix of `axes` whose total size divides `dim`."""
    out: list[str] = []
    size = 1
    for a in axes:
        s = ctx.axis_size(a)
        if s <= 1:
            continue
        if dim % (size * s) == 0:
            out.append(a)
            size *= s
        else:
            break
    return tuple(out)


def _norm_elem(dim: int, elem, ctx: ShardCtx):
    """Normalize one spec element with divisibility fallback."""
    if elem is None:
        return None
    axes = (elem,) if isinstance(elem, str) else tuple(elem)
    ok = axes_that_divide(dim, axes, ctx)
    if not ok:
        return None
    return ok[0] if len(ok) == 1 else ok


def spec_for(shape: tuple[int, ...], elems: tuple,
             ctx: ShardCtx | None = None) -> tuple:
    ctx = ctx or _CTX
    assert len(shape) == len(elems), (shape, elems)
    return tuple(_norm_elem(d, e, ctx) for d, e in zip(shape, elems))


def batch_spec(batch: int, ctx: ShardCtx | None = None):
    """Sharding element for the global-batch dim (DP over pod+data)."""
    ctx = ctx or _CTX
    return axes_that_divide(batch, ctx.present_data_axes, ctx) or None


class Sharding(NamedTuple):
    """A spec on a mesh (the JAX package's NamedSharding)."""
    mesh: Any
    spec: tuple


def placements(sharding: Sharding) -> list:
    """DTensor placements of a sharding: for each mesh dimension, Shard(d)
    where the spec's dimension d names it, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in sharding.mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(sharding.spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def occ_epoch_sharding(mesh, data_axis: str, pb: int,
                       rank: int) -> Sharding:
    """Sharding of the OCC engine's stacked (T, pb, ...) epoch inputs: each
    epoch's pb points split over `data_axis` (the paper's P workers) with
    divisibility fallback to replication; the epoch dim stays whole."""
    ctx = ShardCtx(mesh=mesh, data_axes=(data_axis,))
    elem = _norm_elem(pb, data_axis, ctx)
    return Sharding(mesh, (None, elem) + (None,) * (rank - 2))


def occ_validate_sharding(mesh, rank: int) -> Sharding:
    """Replicated: the bounded master's compacted validator buffers.
    Validation is the master re-executed on every rank, so it runs on
    replicated operands and stays exact."""
    return Sharding(mesh, (None,) * rank)


def serve_snapshot_sharding(mesh, rank: int) -> Sharding:
    """Replicated: every rank answers queries against its own full copy of
    the published snapshot (the validator's placement, by construction)."""
    return occ_validate_sharding(mesh, rank)


def serve_query_sharding(mesh, data_axis: str, bucket: int,
                         rank: int) -> Sharding:
    """A bucket-padded query microbatch: rows split over `data_axis`
    (divisibility fallback to replication), trailing dims whole."""
    ctx = ShardCtx(mesh=mesh, data_axes=(data_axis,))
    elem = _norm_elem(bucket, data_axis, ctx)
    return Sharding(mesh, (elem,) + (None,) * (rank - 1))


# ---------------------------------------------------------------------------
# Running a row-sharded computation on the ranks.
# ---------------------------------------------------------------------------

class AxisShard(NamedTuple):
    """This rank's block of a dimension split over one mesh axis: block
    `index` of `parts`, in the axis group's rank order."""
    group: Any
    index: int
    parts: int

    def rows(self, n: int) -> tuple[int, int]:
        per = n // self.parts
        return self.index * per, (self.index + 1) * per


def axis_shard(sharding: Sharding, dim: int) -> AxisShard | None:
    """The block of dimension `dim` this rank holds under `sharding`, or
    None where the dimension is whole (no mesh, or the fallback)."""
    if sharding.mesh is None:
        return None
    elem = sharding.spec[dim]
    if elem is None:
        return None
    if not isinstance(elem, str):
        raise NotImplementedError(f"a dimension over several axes: {elem}")
    group = sharding.mesh.get_group(elem)
    return AxisShard(group, dist.get_rank(group),
                     dist.get_world_size(group))


def gather_rows(tree: Any, shard: AxisShard) -> Any:
    """Every rank's blocks of a tree of tensors (each with the block's rows
    on dim 0), concatenated in group-rank order on every rank.  One
    all_gather: the leaves' bytes go as one uint8 row each (bit-exact,
    whatever their types), in the list form that gloo runs on CUDA tensors
    (through the host) as well as NCCL."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    rows = leaves[0].shape[0]
    if rows == 0 or any(t.shape[0] != rows for t in leaves):
        raise ValueError("gather_rows: leaves need one non-zero row count")
    cols = [t.contiguous().view(torch.uint8).reshape(rows, -1)
            for t in leaves]
    packed = torch.cat(cols, 1)
    parts = [torch.empty_like(packed) for _ in range(shard.parts)]
    dist.all_gather(parts, packed, group=shard.group)
    full = torch.cat(parts, 0)
    out, at = [], 0
    for t, c in zip(leaves, cols):
        w = c.shape[1]
        out.append(full[:, at:at + w].contiguous().view(t.dtype)
                   .reshape((full.shape[0],) + tuple(t.shape[1:])))
        at += w
    return tree_unflatten(tree, out)


def full_tensor(dt):
    """A DTensor gathered whole on every rank (a collective of its mesh):
    the list form of all_gather over each sharded mesh dimension's group,
    last dimension first, the blocks put in mesh-coordinate order.  It
    stands in for `DTensor.full_tensor`, whose functional all-gather gloo
    does not run on CUDA tensors (it faults), where the list form runs
    through the host.  Shards must be even; Partial placements raise."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    coord = mesh.get_coordinate()
    t = dt.to_local()
    for md in reversed(range(mesh.ndim)):
        p = dt.placements[md]
        if p.is_replicate():
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"full_tensor: placement {p} is not ported")
        group = mesh.get_group(md)
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        at = list(coord)
        at[md] = slice(None)
        along = mesh.mesh[tuple(at)].tolist()
        order = dist.get_process_group_ranks(group)
        t = torch.cat([parts[order.index(r)] for r in along], p.dim)
    if tuple(t.shape) != tuple(dt.shape):
        raise ValueError(f"full_tensor: uneven shards of {tuple(dt.shape)}")
    return t


# ---------------------------------------------------------------------------
# Parameter sharding rules, keyed on the JAX layout's parameter paths.
# Each rule: (regex, per-dim spec template). Templates may use "DATA" (ZeRO
# axes), "MODEL", None. First match wins; unmatched params are replicated.
# ---------------------------------------------------------------------------

_RULES: list[tuple[str, tuple]] = [
    (r"tok_embed$",            ("MODEL", "DATA")),        # (V, D)
    (r"lm_head$",              ("DATA", "MODEL")),        # (D, V)
    (r"(wq|wg|wu|in_w|dt_w|fe_w1|cross_wq)$", ("DATA", "MODEL")),  # (D, out)
    (r"(wk|wv|cross_wk|cross_wv)$", ("DATA", "MODEL")),   # (D, kv_out)
    (r"(wo|wd|out_w|fe_w2|cross_wo)$", ("MODEL", "DATA")),  # (in, D)
    (r"router$",               ("DATA", None)),           # (D, E)
    (r"we_(g|u)$",             ("MODEL", "DATA", None)),  # (E, D, F)
    (r"we_d$",                 ("MODEL", None, "DATA")),  # (E, F, D)
    (r"conv_w$",               (None, "MODEL")),          # (width, inner)
    (r"(a_log|d_skip)$",       ("MODEL",)),               # (H_ssm,)
    (r"(qn|kn|norm\w*|.*_norm|gn)$", (None,)),            # norms: replicated
    (r"(ig_w|fg_w|og_w|zg_w)$", ("DATA", "MODEL")),       # xlstm gate projs
    (r"(ig_r|fg_r|og_r|zg_r)$", (None, None)),            # slstm recurrent
]


def _spec_template_for(path: str) -> tuple | None:
    for pat, tmpl in _RULES:
        if re.search(pat, path):
            return tmpl
    return None


def _resolve(path: str, shape: tuple[int, ...], ctx: ShardCtx) -> tuple:
    """The JAX package's rule for one leaf of the JAX layout."""
    tmpl = _spec_template_for(path)
    if tmpl is None:
        return (None,) * len(shape)
    tmpl = tuple(tmpl)
    if len(tmpl) < len(shape):          # stacked layer / segment dims
        tmpl = (None,) * (len(shape) - len(tmpl)) + tmpl
    elif len(tmpl) > len(shape):
        tmpl = tmpl[-len(shape):]
    elems = []
    for d, t in zip(shape, tmpl):
        if t == "DATA":
            elems.append(_norm_elem(d, ctx.present_data_axes, ctx)
                         if ctx.zero3 else None)
        elif t == "MODEL":
            elems.append(_norm_elem(d, ctx.model_axis, ctx))
        else:
            elems.append(_norm_elem(d, t, ctx) if t else None)
    return tuple(elems)


def param_specs(params: dict, ctx: ShardCtx | None = None) -> dict:
    """{name: spec} for the port's parameters (name -> tensor, meta tensor
    or anything with a `shape`), by the JAX package's rules on the JAX
    layout: a block tensor is read at its JAX path ("segments/seg_00/wq",
    `models.model.layer_of`), and a layer of a stacked segment as a row of
    its (L, ...) leaf, whose leading stack dim (always whole) the port's
    per-layer tensor drops.  The model's names are imported here, so the
    OCC and serving paths that import this module load no model code."""
    from repro_torch.models.model import layer_of, stacked_segments
    ctx = ctx or _CTX
    stacked = stacked_segments(params)
    out = {}
    for name, t in params.items():
        shape = tuple(t.shape)
        at = layer_of(name)
        if at is None:
            out[name] = _resolve(name.replace(".", "/"), shape, ctx)
            continue
        stack, _, leaf = at
        if stack in stacked:
            spec = _resolve(f"{stack}/{leaf}", (1,) + shape, ctx)
            assert spec[0] is None, (name, spec)
            out[name] = spec[1:]
        else:
            out[name] = _resolve(f"{stack}/{leaf}", shape, ctx)
    return out


def input_shardings(tree: dict, ctx: ShardCtx | None = None) -> dict:
    """Shardings on the context's mesh for a {name: spec} dict."""
    ctx = ctx or _CTX
    assert ctx.mesh is not None
    return {name: Sharding(ctx.mesh, spec) for name, spec in tree.items()}
