"""xlstm-1.3b [ssm]: 48 blocks, 1 sLSTM per 8 (7:1 mLSTM:sLSTM), 4 heads,
expansion 2, no separate FFN (d_ff=0) (arXiv:2405.04517)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm_expand=2, ssm_conv=4, slstm_every=8, chunk_size=256,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=4, slstm_every=2, d_model=128, num_heads=2, num_kv_heads=2,
    vocab_size=512, chunk_size=16,
    param_dtype="float32", compute_dtype="float32", remat="none",
)

register(FULL, SMOKE)
