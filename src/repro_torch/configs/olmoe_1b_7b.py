"""olmoe-1b-7b [moe]: 16L, 64 experts top-8, d_ff_expert=1024
(arXiv:2409.02060)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, top_k=8, d_ff_expert=1024,
    router_aux_weight=0.01, capacity_factor=1.25,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
    d_ff=256, d_ff_expert=256, num_experts=4, top_k=2,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
