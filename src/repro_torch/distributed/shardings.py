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
dimension split over one axis (or several, in row-major order), and
`gather_rows` assembles the blocks of every rank, in group-rank order, on
every rank (the replicated result); `full_tensor` gathers a DTensor whole
the same way, `unshard` over some of its mesh's axes, and `shard_block`
cuts this rank's block out of a whole tensor.

The language model's mesh (`ModelMesh`): what the JAX package leaves to
GSPMD (`constrain`, `res_constrain`, each parameter's `NamedSharding`) is
explicit here.  Each rank holds its block of every parameter (ZeRO-3 over
the data axes, tensor-parallel over `model`); the model code gathers the
data axes before a block runs and joins the model axis with Megatron's
pair of autograd Functions: `copy_to_model` (forward the identity,
backward an all-reduce SUM) where a replicated activation enters a
tensor-parallel region, `reduce_from_model` (forward an all-reduce SUM,
backward the identity) where the region's partial sums leave it; and
`sum_over_model` (an all-reduce SUM both ways) for a sum that stays inside
the region, each rank using it for its own part (the Mamba block's gated
norm).  Every
collective is a plain `dist.all_reduce` or the list form of
`dist.all_gather`: gloo runs neither DTensor's functional collectives nor a
reduce-scatter on CUDA tensors, and `torch.distributed.nn`'s all-reduce
all-reduces its gradient too, which scales a gradient by the axis size
when the loss is replicated over the axis.  `compat_shard_map` has no
counterpart: the port's per-rank code is the body a shard_map would run.
"""
from __future__ import annotations

import contextlib
import math
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
           "full_tensor", "unshard", "shard_block", "like_dtensor", "is_dtensor",
           "ModelMesh", "copy_to_model", "reduce_from_model", "sum_over_model",
           "gather_model", "model_whole"]


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
    if isinstance(elem, str):
        group = sharding.mesh.get_group(elem)
        return AxisShard(group, dist.get_rank(group),
                         dist.get_world_size(group))
    mesh, axes = sharding.mesh, tuple(elem)
    index, parts = 0, 1
    for a in axes:         # row-major: the first axis outermost
        n = axis_sizes(mesh)[a]
        index, parts = index * n + mesh.get_local_rank(a), parts * n
    return AxisShard(_flat_group(mesh, axes), index, parts)


_FLAT_GROUPS: dict = {}


def _flat_group(mesh, axes: tuple[str, ...]):
    """The process group of this rank's ranks over several mesh axes, in
    row-major order of their coordinates (the order DTensor gives two
    Shard(d) placements on one dim).  Made once per mesh and axes, a
    collective of every rank of the world (`new_subgroups_by_enumeration`);
    the group's rank order must be the row-major one."""
    names = list(mesh.mesh_dim_names)
    key = (tuple(mesh.mesh.flatten().tolist()), tuple(names), axes)
    if key not in _FLAT_GROUPS:
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        t = mesh.mesh.permute(rest + dims).reshape(-1, math.prod(
            mesh.mesh.shape[d] for d in dims))
        lists = t.tolist()
        if any(r != sorted(r) for r in lists):
            raise NotImplementedError(
                f"axes {axes}: the mesh's ranks are not in row-major order")
        _FLAT_GROUPS[key] = dist.new_subgroups_by_enumeration(lists)[0]
    return _FLAT_GROUPS[key]


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


def _gather_axis(t: torch.Tensor, dim: int, mesh, md: int) -> torch.Tensor:
    """This rank's blocks along mesh dimension `md` (each `t` on its rank)
    concatenated on `dim` in mesh-coordinate order, on every rank of the
    axis: the list form of all_gather over the axis's group (bfloat16 sent
    as its bytes, bit-exact: gloo has no bfloat16 type)."""
    if t.dtype == torch.bfloat16:
        return _gather_axis(t.contiguous().view(torch.uint8), dim, mesh,
                            md).view(torch.bfloat16)
    group = mesh.get_group(md)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    at = list(mesh.get_coordinate())
    at[md] = slice(None)
    along = mesh.mesh[tuple(at)].tolist()
    order = dist.get_process_group_ranks(group)
    return torch.cat([parts[order.index(r)] for r in along], dim)


def unshard(dt, axes=None) -> torch.Tensor:
    """A DTensor's local block gathered over the mesh axes in `axes` (all
    of them when None) that shard it: a plain tensor, this rank's block
    over the other axes.  A collective of those axes' groups, last mesh
    dimension first (a dim split over two axes is in row-major order).
    It stands in for `DTensor.full_tensor` / `redistribute`, whose
    functional all-gather gloo does not run on CUDA tensors (it faults),
    where the list form runs through the host.  Shards must be even;
    Partial placements raise."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    t = dt.to_local()
    for md in reversed(range(mesh.ndim)):
        p = dt.placements[md]
        if p.is_replicate() or (axes is not None
                                and mesh.mesh_dim_names[md] not in axes):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"unshard: placement {p} is not ported")
        t = _gather_axis(t, p.dim, mesh, md)
    return t


def full_tensor(dt):
    """A DTensor gathered whole on every rank (a collective of its mesh):
    `unshard` over every axis."""
    t = unshard(dt)
    if tuple(t.shape) != tuple(dt.shape):
        raise ValueError(f"full_tensor: uneven shards of {tuple(dt.shape)}")
    return t


def shard_block(full: torch.Tensor, mesh, pls, axes=None) -> torch.Tensor:
    """This rank's block of `full` under placements `pls` on `mesh`, over
    the mesh axes in `axes` (all when None): a view, each Shard(d) cut
    evenly in mesh-dimension order (row-major where two split one dim).
    No collective."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for md, p in enumerate(pls):
        if not isinstance(p, Shard) or (
                axes is not None and mesh.mesh_dim_names[md] not in axes):
            continue
        n = full.shape[p.dim] // mesh.mesh.shape[md]
        full = full.narrow(p.dim, coord[md] * n, n)
    return full


def like_dtensor(local: torch.Tensor, dt):
    """`local` (this rank's block) as a DTensor with `dt`'s mesh,
    placements and global shape; no collective."""
    from torch.distributed.tensor import DTensor
    shape = tuple(dt.shape)
    stride = tuple(int(math.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(local, dt.device_mesh, dt.placements,
                              run_check=False, shape=dt.shape, stride=stride)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


# ---------------------------------------------------------------------------
# The language model's mesh: tensor parallelism over the model axis, data
# parallelism (rows, ZeRO-3 blocks) over the data axes.
# ---------------------------------------------------------------------------

class ModelMesh:
    """One rank's view of a mesh for the language model.

    `size` ranks share the model axis (1 when the mesh has none); this is
    `rank` of them.  `splits(n)` is the JAX package's rule for a dimension
    of n over the model axis (`axes_that_divide`): a head count, d_ff or a
    vocabulary is split when the axis divides it, else whole on every
    rank.  Rows of a batch split over the data axes by `batch_spec`."""

    def __init__(self, mesh, ctx: ShardCtx | None = None):
        if ctx is None or ctx.mesh is not mesh:
            ctx = ShardCtx(mesh=mesh)
        sizes = axis_sizes(mesh)
        self.mesh, self.ctx = mesh, ctx
        axis = ctx.model_axis
        self.size = sizes.get(axis, 1)
        self.rank = mesh.get_local_rank(axis) if axis in sizes else 0
        self.group = mesh.get_group(axis) if self.size > 1 else None
        self.data_axes = tuple(a for a in ctx.present_data_axes
                               if sizes[a] > 1)
        self.data_size = math.prod(sizes[a] for a in self.data_axes)

    def splits(self, n: int) -> bool:
        return self.size > 1 and n % self.size == 0

    # ------------------------------------------------------------- rows
    def rows(self, b: int) -> tuple[int, int]:
        """[lo, hi) of the rows of a batch of b this rank computes."""
        axes = batch_spec(b, self.ctx) or ()
        index, parts = 0, 1
        for a in axes:
            n = self.ctx.axis_size(a)
            index, parts = index * n + self.mesh.get_local_rank(a), parts * n
        per = b // parts
        return index * per, (index + 1) * per

    def gather_rows(self, t: torch.Tensor, b: int) -> torch.Tensor:
        """Every rank's rows (dim 0) of a batch of b, whole on every rank."""
        names = list(self.mesh.mesh_dim_names)
        for a in reversed(batch_spec(b, self.ctx) or ()):
            t = _gather_axis(t, 0, self.mesh, names.index(a))
        return t

    # ------------------------------------------------------ data reduce
    def _over_data(self, t: torch.Tensor) -> torch.Tensor:
        for a in self.data_axes:
            dist.all_reduce(t, group=self.mesh.get_group(a))
        return t

    def data_mean(self, loss, grads: dict, like: dict):
        """(the mean of every data rank's loss, each gradient's mean over
        the data ranks cut to this rank's block of `like[name]`'s
        placements, f32).  One all-reduce SUM a data axis over one f32
        buffer (gloo has no reduce-scatter for CUDA tensors), filled leaf
        by leaf: each gradient leaves `grads` (the caller's dict is
        emptied) as it is copied in, so no leaf is held twice over and the
        peak is the buffer and the gradients not yet copied (a rank's
        experts of phi3.5-moe are 1.3 G gradients)."""
        shapes = {n: g.shape for n, g in grads.items()}
        flat = torch.empty(1 + sum(g.numel() for g in grads.values()),
                           dtype=torch.float32, device=loss.device)
        flat[0] = loss
        at = 1
        for n, shape in shapes.items():
            k = math.prod(shape)
            flat[at:at + k].copy_(grads.pop(n).reshape(-1))
            at += k
        flat = self._over_data(flat).div_(self.data_size)
        out, at = {}, 1
        for n, shape in shapes.items():
            k = math.prod(shape)
            g = flat[at:at + k].view(shape)
            at += k
            t = like[n]
            # a copy, not a view: the buffer is freed on return
            out[n] = (shard_block(g, t.device_mesh, t.placements,
                                  self.data_axes).clone(
                memory_format=torch.contiguous_format)
                if is_dtensor(t) else g)
        return flat[0].clone(), out

    def _over_mesh(self, t: torch.Tensor, op) -> torch.Tensor:
        for md in range(self.mesh.ndim):
            dist.all_reduce(t, op=op, group=self.mesh.get_group(md))
        return t

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over every rank of the mesh."""
        return self._over_mesh(t.clone(), dist.ReduceOp.MAX)

    def global_norm(self, grads: dict, like: dict) -> torch.Tensor:
        """sqrt of every leaf's squares summed once over the mesh: each
        rank adds its block of a leaf where it is the first of the ranks
        that hold the same block (coordinate 0 on the axes the leaf is
        replicated over), then one all-reduce SUM a mesh axis."""
        coord = self.mesh.get_coordinate()
        sq = torch.zeros((), dtype=torch.float32,
                         device=next(iter(grads.values())).device)
        for n, g in grads.items():
            pls = like[n].placements
            if all(c == 0 for c, p in zip(coord, pls) if p.is_replicate()):
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(self._over_mesh(sq, dist.ReduceOp.SUM))

    # -------------------------------------------------- model-axis gathers
    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's block of `t`, concatenated on `dim` (no
        autograd)."""
        names = list(self.mesh.mesh_dim_names)
        return _gather_axis(t, dim, self.mesh, names.index(
            self.ctx.model_axis))

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """`t` all-reduced (SUM unless `op`) over the model axis, in place
        (no autograd)."""
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=self.group)
        return t


def _sum_f32(t: torch.Tensor, mm: ModelMesh) -> torch.Tensor:
    """`t` summed over the model axis in f32, cast back to its type."""
    return mm.all_reduce(t.to(torch.float32).contiguous()).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mm):
        ctx.mm = mm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.mm), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mm):
        return _sum_f32(x, mm)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mm):
        ctx.mm = mm
        return _sum_f32(x, mm)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.mm), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mm, partial):
        ctx.dim, ctx.mm, ctx.partial = dim, mm, partial
        return mm.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        mm = ctx.mm
        if ctx.partial:
            g = _sum_f32(g, mm)
        n = g.shape[ctx.dim] // mm.size
        return g.narrow(ctx.dim, mm.rank * n, n).contiguous(), None, None, \
            None


def copy_to_model(x: torch.Tensor, mm: ModelMesh | None) -> torch.Tensor:
    """Megatron's f: the identity forward; the backward all-reduces the
    gradient over the model axis (each rank's graph from here on is a
    part of the whole).  The identity without a model axis."""
    if mm is None or mm.size == 1:
        return x
    return _CopyToModel.apply(x, mm)


def reduce_from_model(x: torch.Tensor, mm: ModelMesh | None) -> torch.Tensor:
    """Megatron's g: the forward all-reduces the model ranks' partial sums
    (in f32, cast back); the backward is the identity."""
    if mm is None or mm.size == 1:
        return x
    return _ReduceFromModel.apply(x, mm)


def sum_over_model(x: torch.Tensor, mm: ModelMesh | None) -> torch.Tensor:
    """The model ranks' partial sums added (in f32, cast back), where the
    sum stays inside the tensor-parallel region: each rank uses it for its
    own part of the whole, so the backward all-reduces too (each rank's
    gradient of the sum is a part of the whole gradient).  The identity
    without a model axis."""
    if mm is None or mm.size == 1:
        return x
    return _SumOverModel.apply(x, mm)


def gather_model(x: torch.Tensor, dim: int, mm: ModelMesh,
                 partial: bool) -> torch.Tensor:
    """Every model rank's block of a weight, whole on `dim`.  Its backward
    keeps this rank's block of the gradient: summed over the model ranks
    first where each rank's use is a part of the whole (`partial`), as is
    where every rank computes the same thing."""
    return _GatherModel.apply(x, dim, mm, partial)


def model_whole(w: torch.Tensor, dim: int, n: int, mm: ModelMesh | None,
                partial: bool) -> torch.Tensor:
    """A weight whose dimension `dim` is n whole: gathered where the model
    axis splits n (`ModelMesh.splits`), else as it is (`copy_to_model`
    where `partial`, so its gradient sums the ranks' parts)."""
    if mm is None or mm.size == 1:
        return w
    if mm.splits(n):
        return gather_model(w, dim, mm, partial)
    return copy_to_model(w, mm) if partial else w


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
