"""xlstm-125m [arXiv:2405.04517] — alternating sLSTM / mLSTM blocks, no FFN.

Assumption (config tier: unverified): sLSTM every 4th block (xLSTM-paper
ratios are 7:1 / 1:0 depending on variant; the 125M table is mLSTM-heavy).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    mlp_type="none", block_pattern="xlstm", slstm_every=4,
    scan_layers=False,  # heterogeneous blocks; 12 layers — unrolled is fine
)
