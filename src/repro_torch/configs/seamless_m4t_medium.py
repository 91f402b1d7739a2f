"""seamless-m4t-medium [audio] — enc-dec, multimodal.  [arXiv:2308.11596; hf]

Backbone only: 12L encoder over precomputed audio-frame embeddings (STUB)
+ 12L causal decoder with cross-attention.  kv=16 means full MHA.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    enc_layers=12, frontend="audio", frontend_dim=160, frontend_len=1024,
    rope_theta=10_000.0,
    source="arXiv:2308.11596",
)
