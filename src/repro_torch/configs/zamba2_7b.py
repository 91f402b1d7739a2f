"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block applied
every 6 layers (weights shared, per-application KV caches distinct).
[arXiv:2411.15242; unverified]

Sub-quadratic: runs long_500k (attention KV context-parallel-sharded).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    attn_every=6, subquadratic=True,
    rope_theta=10_000.0,
    source="arXiv:2411.15242",
)
