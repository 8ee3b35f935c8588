"""zamba2-2.7b [hybrid]: 54 Mamba2 layers + one SHARED attention block
applied every 6 layers; ssm_state=64 (arXiv:2411.15242)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6, chunk_size=256,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=4, shared_attn_every=2, d_model=128, num_heads=4,
    num_kv_heads=4, d_ff=256, ssm_state=16, ssm_head_dim=32,
    vocab_size=512, chunk_size=16,
    param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
