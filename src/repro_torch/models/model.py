"""The language model: init, loss, prefill and one-token decode, on one
device or on a mesh.

The port of `repro/models/model.py`.
`Model` is an `nn.Module` holding its parameters under the JAX package's
names:

  tok_embed (V, D), final_norm (D,), lm_head (D, V) unless tied,
  segments.seg_00 = [per-layer ParameterDict]  (the JAX package stacks the
                                                layers and scans them)
  shared = ParameterDict                       (the hybrid family's shared
                                                attention block, one set of
                                                tensors for all its uses)
  frontend = ParameterDict                     (the vision and audio
                                                families' projector: fe_w1,
                                                fe_w2, fe_norm)
  encoder.segments = [per-layer ParameterDict] (the encoder-decoder's
  encoder.norm (D,)                             encoder; the JAX package
                                                stacks its layers under
                                                encoder/segments/<leaf>)

every tensor in the config's dtype but the MoE router and Mamba's a_log,
dt_bias and d_skip, which are f32 (as in the JAX package).  A shared
segment has no entry under `segments` (nor has it in the JAX package).

A batch holds "tokens" (B, S) (and "labels" for the loss); the frontend
families' batches add "frontend" (B, F, frontend_dim), precomputed patch or
frame embeddings.  The vision family (vlm) projects them into a prefix of
F positions before the tokens (`_embed`); the loss skips the prefix, and
decode continues at position F + S after a prefill of S tokens.  The
encoder-decoder (audio) runs them through its encoder (`_encode`), whose
output every decoder block attends to.

Caches mirror the segments, shared ones included: {"seg_00": [cache per
layer]}, {"k", "v"} (B, S, Hkv, hd) for an attention block (each use of
the shared block its own; a decoder block adds the static cross keys and
values "ck", "cv" (B, F, Hkv, hd)), the recurrent state for a Mamba,
mLSTM or sLSTM block; `convert.lm_caches_to_numpy` gives them in the JAX
layout.  `decode_step` writes the caches in place.  The parameters are
trainable: `loss(batch)` (also `forward`, so `torch.func.functional_call`
can run it on a training state's tensors) is the mean next-token loss
that `training/step.py` differentiates, each block rematerialized as
`cfg.remat` says.  `prefill` and `decode_step` run under
`torch.inference_mode()`.  `backend` is the kernels' dispatch ("auto": a
CUDA tensor launches the kernels, forward and backward; "plain": the plain
versions, which autograd differentiates as they are, for comparisons).

On a mesh (`Model(cfg, mesh=...)`, one process a rank) each parameter is a
DTensor holding this rank's block, placed by `distributed.shardings.
param_specs` under the installed `shard_ctx` (ZeRO-3 over the data axes
when `ShardCtx.zero3`, tensor-parallel over `model`), and `init` draws
each whole tensor from the generator, one at a time, and keeps the block,
so the weights equal one device's for the same seed.  A forward gathers a
block's data axes before it runs (`transformer.local_weights`); the model
axis splits heads, d_ff, the MoE experts, the Mamba2 heads and (where it
divides it) the vocabulary (`ModelMesh`).  `prefill` and `decode_step` take the whole batch on every
rank, run this rank's rows (`local_batch`: the data axes split them as
`batch_spec` says) and return the whole (B, V) logits on every rank;
their caches are this rank's blocks (`init_cache`).  `loss` takes this
rank's rows (the train step cuts them) and returns their mean, the same on
every model rank.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.distributed.shardings import (
    ModelMesh, Sharding, current_ctx, is_dtensor, param_specs, placements,
    shard_block,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models.frontend import (
    frontend_project, frontend_shapes, init_frontend,
)
from repro_torch.models.layers import (
    cross_entropy_chunked, embed, embed_init, rmsnorm,
)
from repro_torch.models.transformer import (
    block_shapes, init_block, init_block_cache, local_weights,
    require_mesh_ported, run_stack_decode, run_stack_train, segments_for,
)

__all__ = ["Model", "build_model", "layer_of", "stacked_segments",
           "jax_ranks"]


def _seg_key(i: int) -> str:
    return f"seg_{i:02d}"


# The JAX path of the node that stacks the encoder's layers.
ENCODER_STACK = "encoder/segments"


def layer_of(name: str) -> tuple[str, int, str] | None:
    """(stack, layer, leaf) of a block tensor's parameter name: `stack` is
    the JAX path of the node holding the block's leaves, "segments/seg_00"
    for "segments.seg_00.3.wq" and ENCODER_STACK for
    "encoder.segments.3.wq"; None for the others ("tok_embed",
    "final_norm", "lm_head", the shared block's "shared.wq",
    "frontend.fe_w1", "encoder.norm")."""
    parts = name.split(".")
    if len(parts) == 4 and parts[0] == "segments":
        return f"segments/{parts[1]}", int(parts[2]), parts[3]
    if len(parts) == 4 and parts[:2] == ["encoder", "segments"]:
        return ENCODER_STACK, int(parts[2]), parts[3]
    return None


def stacked_segments(names) -> set[str]:
    """The stacks (`layer_of`) among `names` (parameter names) whose layers
    the JAX package stacks on a leading dim: a segment of more than one
    layer, and the encoder at any depth (its init vmaps over enc_layers
    keys).  A segment of one layer is not stacked (`init_block` without
    the vmap), nor is a shared segment (`params["shared"]`, one set of
    tensors for all its uses, which `segments_for` gives a count of 1)."""
    layers: dict[str, set[int]] = {}
    for n in names:
        at = layer_of(n)
        if at is not None:
            layers.setdefault(at[0], set()).add(at[1])
    return {stack for stack, ls in layers.items()
            if len(ls) > 1 or stack == ENCODER_STACK}


def jax_ranks(params: dict) -> dict[str, int]:
    """name -> the rank of the tensor as the JAX package lays it out: one
    more than its own for a block tensor of a stack (`stacked_segments`:
    "segments.seg_00.3.norm1" (D,) is a row of the (L, D) leaf, as is
    "encoder.segments.3.norm1"); its own for tok_embed, lm_head,
    final_norm, the shared block's and the frontend's tensors,
    encoder.norm and the tensors of a segment that is not stacked."""
    stacked = stacked_segments(params)
    out = {}
    for n, t in params.items():
        at = layer_of(n)
        out[n] = t.dim() + int(at is not None and at[0] in stacked)
    return out


class Model(nn.Module):
    """A language model of one `ArchConfig` on one device.

    The constructor allocates the parameters uninitialised, in the config's
    dtype, directly on `device` ("cuda" by default; "cpu"; or "meta" to
    count parameters without memory); `init` fills them from a
    `torch.Generator` on that device, and `convert.lm_params_from_numpy`
    from a JAX parameter tree.  `mesh` (a DeviceMesh over the process
    group, of `device`'s type): each parameter this rank's block, a DTensor
    (placements from `shard_ctx`'s settings when its mesh is `mesh`, else
    the defaults).
    """

    def __init__(self, cfg, device: str | torch.device = "cuda",
                 backend: str = "auto", mesh=None):
        super().__init__()
        segs = segments_for(cfg)
        dev = torch.device(device)
        if dev.type != "meta":
            dev = resolve_device(dev)
        self.cfg = cfg
        self.backend = backend
        self.mp = None if mesh is None else ModelMesh(mesh, current_ctx())
        require_mesh_ported(cfg, self.mp)
        dt = getattr(torch, cfg.dtype)
        at = torch.device("meta") if mesh is not None else dev

        def empty(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=at))
        self.tok_embed = empty(cfg.vocab, cfg.d_model)
        self.final_norm = empty(cfg.d_model)
        self.lm_head = None if cfg.tie_embeddings else empty(cfg.d_model,
                                                             cfg.vocab)
        def block(kind):
            return nn.ParameterDict({n: empty(*s, dtype=t) for n, (s, t) in
                                     block_shapes(cfg, kind, dt).items()})
        self.segments = nn.ModuleDict({
            _seg_key(i): nn.ModuleList([block(kind) for _ in range(count)])
            for i, (kind, count, shared) in enumerate(segs) if not shared})
        # the hybrid family's one shared kind (`segments_for`)
        shared = next((kind for kind, _, is_shared in segs if is_shared),
                      None)
        self.shared = None if shared is None else block(shared)
        self.frontend = nn.ParameterDict({
            n: empty(*shape) for n, shape in frontend_shapes(cfg).items()
        }) if cfg.frontend else None
        self.encoder = None
        if cfg.is_encdec:
            self.encoder = nn.Module()
            self.encoder.segments = nn.ModuleList(
                [block("enc_attn_mlp") for _ in range(cfg.enc_layers)])
            self.encoder.norm = empty(cfg.d_model)
        if mesh is not None:
            self._place(dev)

    def _place(self, dev: torch.device) -> None:
        """Replace each (meta) parameter by a DTensor of this rank's block,
        uninitialised, on `dev`."""
        from torch.distributed.tensor import DTensor
        mesh = self.mp.mesh
        named = dict(self.named_parameters())
        for name, spec in param_specs(named, self.mp.ctx).items():
            meta = named[name]
            pls = placements(Sharding(mesh, spec))
            local = torch.empty(
                shard_block(meta, mesh, pls).shape, dtype=meta.dtype,
                device=dev)
            stride = tuple(int(math.prod(meta.shape[i + 1:]))
                           for i in range(meta.dim()))
            block = DTensor.from_local(local, mesh, pls, run_check=False,
                                       shape=meta.shape, stride=stride)
            *outer, leaf = name.split(".")
            owner = self.get_submodule(".".join(outer)) if outer else self
            if isinstance(owner, nn.ParameterDict):
                owner[leaf] = nn.Parameter(block)
            else:
                setattr(owner, leaf, nn.Parameter(block))

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.tok_embed.dtype

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "Model":
        """Fill every parameter from `gen` (a generator on the model's
        device) with the JAX package's distributions: normal embeddings
        and projections scaled by fan-in^-0.5, norms at one.  Each tensor is
        drawn in f32 on the device and cast; returns self.  On a mesh each
        rank draws every whole tensor in the same order and keeps its
        block."""
        cfg, dt = self.cfg, self.dtype
        put = self.put
        put(self.tok_embed, embed_init(gen, cfg.vocab, cfg.d_model, dt))
        put(self.final_norm, torch.ones(cfg.d_model, dtype=dt))
        if self.lm_head is not None:
            put(self.lm_head, embed_init(gen, cfg.vocab, cfg.d_model, dt).T)
        blocks = []     # in the segments' order; the shared block once
        for i, (kind, _, shared) in enumerate(segments_for(cfg)):
            if not shared:
                blocks += [(kind, layer) for layer in
                           self.segments[_seg_key(i)]]
            elif all(layer is not self.shared for _, layer in blocks):
                blocks.append((kind, self.shared))
        if self.encoder is not None:
            blocks += [("enc_attn_mlp", layer)
                       for layer in self.encoder.segments]
            put(self.encoder.norm, torch.ones(cfg.d_model, dtype=dt))
        for kind, layer in blocks:
            for name, t in init_block(gen, cfg, kind, dt):
                put(layer[name], t)
                del t
        if self.frontend is not None:
            for name, t in init_frontend(gen, cfg, dt).items():
                put(self.frontend[name], t)
        return self

    @staticmethod
    @torch.no_grad()
    def put(param, full: torch.Tensor) -> None:
        """Fill a parameter from its whole value: on a mesh, this rank's
        block of it."""
        if is_dtensor(param):
            param.to_local().copy_(shard_block(full.to(param.device),
                                               param.device_mesh,
                                               param.placements))
        else:
            param.copy_(full)

    # --------------------------------------------------------------- helpers
    def _layers(self, i: int, shared: bool, count: int):
        """The parameter dicts segment i runs in order: its layers, or the
        shared block `count` times."""
        return [self.shared] * count if shared \
            else self.segments[_seg_key(i)]

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        """A top-level parameter as a forward runs on it
        (`transformer.local_weights`)."""
        return local_weights({"t": t}, self.mp)["t"]

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of every entry of a batch (the data axes split
        them as `batch_spec` says); the batch itself without a mesh."""
        if self.mp is None:
            return batch
        lo, hi = self.mp.rows(len(batch["tokens"]))
        return {k: v[lo:hi] for k, v in batch.items()}

    def _whole_logits(self, logits: torch.Tensor, b: int) -> torch.Tensor:
        """(rows, V or V/m) logits of this rank -> (b, V) on every rank."""
        if self.mp is None:
            return logits
        if self.mp.splits(self.cfg.vocab):
            logits = self.mp.gather(logits.contiguous(), 1)
        return self.mp.gather_rows(logits, b)

    def _ids(self, a) -> torch.Tensor:
        """Token ids or positions (numpy or tensor) as int64 on the device."""
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return torch.as_tensor(a, device=self.device).long()

    def _lm_head(self) -> torch.Tensor:
        return self._w(self.tok_embed).T if self.lm_head is None \
            else self._w(self.lm_head)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x.contiguous(), self._w(self.final_norm),
                    self.cfg.norm_eps, self.backend)
        return (h @ self._lm_head())[:, 0].to(torch.float32)

    def _project(self, batch: dict) -> torch.Tensor:
        """The frontend's embeddings batch["frontend"] (B, F, frontend_dim)
        projected and normed (fe_norm): (B, F, D)."""
        emb = batch["frontend"]
        if isinstance(emb, np.ndarray):
            emb = torch.from_numpy(np.ascontiguousarray(emb))
        p = local_weights(self.frontend, self.mp)
        h = frontend_project(p, torch.as_tensor(emb, device=self.device),
                             self.cfg)
        return rmsnorm(h, p["fe_norm"], self.cfg.norm_eps, self.backend)

    def _embed(self, batch: dict):
        """-> (x (B, n_prefix + S, D), n_prefix): the token embeddings,
        after the projected prefix of the vision family (n_prefix = F;
        0 for the others, the encoder-decoder included)."""
        x = embed(self._w(self.tok_embed), self._ids(batch["tokens"]),
                  self.cfg.vocab, self.mp)
        if not self.cfg.frontend or self.cfg.is_encdec:
            return x, 0
        pre = self._project(batch)
        return torch.cat([pre.to(x.dtype), x], 1), pre.shape[1]

    def _encode(self, batch: dict) -> torch.Tensor:
        """The encoder-decoder's encoder on batch["frontend"]: the projected
        frames through the encoder's blocks (bidirectional) and its norm,
        (B, F, D)."""
        cfg = self.cfg
        x = self._project(batch)
        x, _ = run_stack_train(self.encoder.segments, x, cfg, "enc_attn_mlp",
                               self._positions(x.shape[1]),
                               backend=self.backend, mp=self.mp)
        return rmsnorm(x, self._w(self.encoder.norm), cfg.norm_eps,
                       self.backend)

    def _body_train(self, x: torch.Tensor, positions: torch.Tensor,
                    enc_out=None, want_cache: bool = False):
        """The full-sequence forward of every segment -> (x (B, S, D),
        caches {"seg_00": [cache per layer]} if `want_cache`, else {}).
        `enc_out`: the encoder's output, which the decoder blocks attend
        to (the other kinds ignore it).  No final norm."""
        caches = {}
        for i, (kind, count, shared) in enumerate(segments_for(self.cfg)):
            x, cache = run_stack_train(
                self._layers(i, shared, count), x, self.cfg, kind, positions,
                want_cache=want_cache, backend=self.backend,
                cross_kv=enc_out, mp=self.mp)
            if want_cache:
                caches[_seg_key(i)] = cache
        return x, caches

    def _positions(self, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ loss
    def loss(self, batch: dict) -> torch.Tensor:
        """batch["tokens"], batch["labels"] (B, S) ints (numpy or tensors),
        and "frontend" for the frontend families, -> the mean next-token
        cross entropy over the tokens, a 0-d f32 tensor: embed (and
        encode), the blocks (rematerialized as cfg.remat says), the final
        norm, the vision prefix sliced off, and `cross_entropy_chunked` in
        chunks of cfg.attn_chunk.  On a mesh, `batch` is this rank's rows
        (`local_batch`) and the loss their mean."""
        cfg = self.cfg
        enc_out = self._encode(batch) if cfg.is_encdec else None
        x, n_prefix = self._embed(batch)
        x, _ = self._body_train(x, self._positions(x.shape[1]), enc_out)
        h = rmsnorm(x, self._w(self.final_norm), cfg.norm_eps, self.backend)
        if n_prefix:
            h = h[:, n_prefix:]
        mp = self.mp if self.mp is not None and self.mp.splits(cfg.vocab) \
            else None
        return cross_entropy_chunked(h, self._lm_head(),
                                     self._ids(batch["labels"]),
                                     seq_chunk=cfg.attn_chunk, mp=mp)

    def forward(self, batch: dict) -> torch.Tensor:
        """The training forward: `loss(batch)`."""
        return self.loss(batch)

    # --------------------------------------------------------------- prefill
    @torch.inference_mode()
    def prefill(self, batch: dict):
        """batch["tokens"] (B, S) (and "frontend") -> (last-token logits
        (B, V) f32, caches {"seg_00": [cache per layer]}: {"k", "v"} (B,
        n_prefix + S, Hkv, hd) of an attention block, with "ck", "cv" (B,
        F, Hkv, hd) of a decoder block, the state after the sequence of a
        recurrent one).  On a mesh the logits are whole on every rank and
        the caches this rank's blocks in decode mode "tp"'s layout."""
        b = len(batch["tokens"])
        batch = self.local_batch(batch)
        enc_out = self._encode(batch) if self.cfg.is_encdec else None
        x, _ = self._embed(batch)
        x, caches = self._body_train(x, self._positions(x.shape[1]),
                                     enc_out, want_cache=True)
        return self._whole_logits(self._logits(x[:, -1:]), b), caches

    # ----------------------------------------------------------------- cache
    @torch.inference_mode()
    def init_cache(self, batch: int, cache_len: int,
                   decode_mode: str = "tp") -> dict:
        """Zeroed slot caches on the model's device: {"seg_00": [cache per
        layer]}, {"k", "v"} (batch, cache_len, Hkv, hd) in the model's dtype
        for an attention block (each use of the shared block its own; a
        decoder block's cross keys and values "ck", "cv" zeros of
        (batch, frontend_len, Hkv, hd), as in the JAX package), the
        recurrent state (`init_block_cache`) for the others.  On a mesh,
        this rank's blocks for decoding in `decode_mode`
        (`attention.init_kv_cache`)."""
        if self.mp is not None:
            lo, hi = self.mp.rows(batch)
            batch = hi - lo
        return {_seg_key(i): [init_block_cache(self.cfg, kind, batch,
                                               cache_len, self.dtype,
                                               self.device, mp=self.mp,
                                               mode=decode_mode)
                              for _ in range(count)]
                for i, (kind, count, _) in
                enumerate(segments_for(self.cfg))}

    def decode_layout(self, cache_len: int, decode_mode: str) -> str:
        """The mode a cache of `cache_len` decodes in: "cp" only where it
        runs context-parallel (`attention.cp_splits`; the JAX package runs
        "cp" as "tp" elsewhere)."""
        return "cp" if attn_mod.cp_splits(cache_len, self.mp, decode_mode) \
            else "tp"

    # ----------------------------------------------------------------- decode
    @torch.inference_mode()
    def decode_step(self, caches: dict, tokens, pos,
                    decode_mode: str = "tp"):
        """tokens (B, 1), pos (B,) (numpy or tensors of ints) -> (logits
        (B, V) f32, caches), the caches written in place: keys and values
        at `pos`, every lane's recurrent state advanced by its token.  On a
        mesh, tokens and pos are the whole batch on every rank, the caches
        this rank's blocks for `decode_mode` (`init_cache`; see
        `decode_layout`), and the logits whole on every rank."""
        cfg = self.cfg
        b = len(tokens)
        rows = self.local_batch({"tokens": tokens, "pos": pos})
        x = embed(self._w(self.tok_embed), self._ids(rows["tokens"]),
                  cfg.vocab, self.mp)
        pos = self._ids(rows["pos"])
        for i, (kind, count, shared) in enumerate(segments_for(cfg)):
            x, _ = run_stack_decode(self._layers(i, shared, count), x, cfg,
                                    kind,
                                    caches[_seg_key(i)], pos,
                                    decode_mode=decode_mode,
                                    backend=self.backend, mp=self.mp)
        return self._whole_logits(self._logits(x), b), caches

    # ------------------------------------------------------------- param count
    def param_count(self) -> int:
        return sum(math.prod(p.shape) for p in self.parameters())


def build_model(cfg, device: str | torch.device = "cuda",
                backend: str = "auto", mesh=None) -> Model:
    """An uninitialised `Model` of `cfg` on `device` (and `mesh`); fill it
    with `.init(generator)` or `convert.lm_params_from_numpy`."""
    return Model(cfg, device=device, backend=backend, mesh=mesh)
