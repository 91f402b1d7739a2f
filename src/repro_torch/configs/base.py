"""Architecture / shape / run configuration dataclasses (the port's copy
of the JAX package's `configs/base.py`, as plain data).

Every assigned architecture is a frozen `ArchConfig`; the four canonical
input shapes are `ShapeConfig`s.  `reduced()` produces the same-family
small config used by the CPU tests; the port runs full configs on the
card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

__all__ = ["MoEConfig", "ArchConfig", "ShapeConfig", "SHAPES", "reduced",
           "supports_shape", "TrainConfig"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    impl: str = "capacity"           # "capacity" | "dense" | "ragged"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    attn_every: int = 0              # hybrid: shared attn applied after every k ssm layers
    # xLSTM
    slstm_every: int = 0             # sLSTM block at layers (i+1) % slstm_every == 0
    # encoder-decoder
    enc_layers: int = 0
    # modality frontend stub
    frontend: str | None = None      # "audio" | "vision"
    frontend_dim: int = 0            # stub embedding dim
    frontend_len: int = 256          # stub frames / patches per example
    # capabilities
    subquadratic: bool = False       # may run long_500k
    dtype: str = "bfloat16"
    remat: str = "full"              # "none" | "full" | "dots"
    attn_impl: str = "chunked"       # "chunked" | "ref" | "flash"
    attn_chunk: int = 512
    ssm_chunk: int = 256
    unroll: bool = False             # unroll all scans (analytic-model validation)
    source: str = ""                 # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def supports_shape(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) cells are defined.  long_500k needs sub-quadratic
    attention (decode cost O(S) per token for dense-attention models is a
    0.5 TB KV read per token per example — skipped per assignment)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
    return True, ""


def reduced(arch: ArchConfig) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests."""
    kw: dict = dict(
        n_layers=min(arch.n_layers, 4 if (arch.attn_every or arch.slstm_every) else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(arch.n_kv_heads, 2),
        d_ff=0 if arch.d_ff == 0 else 128,
        vocab=128,
        head_dim=16,
        frontend_dim=32 if arch.frontend else 0,
        frontend_len=8 if arch.frontend else arch.frontend_len,
        enc_layers=min(arch.enc_layers, 2),
        attn_chunk=32,
        ssm_chunk=16,
        remat="none",
    )
    if arch.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(arch.moe.top_k, 2),
                              capacity_factor=2.0, impl=arch.moe.impl)
    if arch.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
    if arch.attn_every:
        kw["attn_every"] = 2
    if arch.slstm_every:
        kw["slstm_every"] = 2
    return arch.replace(**kw)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient accumulation steps
    compress_cross_pod: bool = False # int8 error-feedback on cross-pod reduce
    seed: int = 0
