"""granite-20b [dense]: code model, MQA (kv=1) (arXiv:2405.04324)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    mlp_kind="gelu",  # gpt-bigcode lineage: plain (non-gated) GELU MLP
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, d_ff=512,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
