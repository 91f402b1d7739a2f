"""internvl2-2b [vlm] — InternViT (STUB patch embeddings) + InternLM2
backbone.  [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    frontend="vision", frontend_dim=1024, frontend_len=256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
)
