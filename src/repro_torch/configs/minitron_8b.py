"""minitron-8b [dense]: pruned nemotron, squared-ReLU MLP, GQA kv=8
(arXiv:2407.14679)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000,
    mlp_kind="squared_relu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
