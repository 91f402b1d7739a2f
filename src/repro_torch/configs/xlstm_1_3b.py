"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1 interleave), d_ff=0
(cells carry their own expansion).  [arXiv:2405.04517; unverified]

Sub-quadratic: recurrent state decode, runs long_500k.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=512,
    slstm_every=8, subquadratic=True,
    source="arXiv:2405.04517",
)
