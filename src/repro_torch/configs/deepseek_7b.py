"""deepseek-7b [dense]: llama-arch 30L (arXiv:2401.02954)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    mlp_kind="gated_silu", rope_base=10000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    attn_block_q=512,
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
    attn_block_q=0,
)

register(FULL, SMOKE)
