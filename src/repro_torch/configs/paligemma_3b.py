"""paligemma-3b [vlm]: SigLIP tower STUBBED (patch embeddings provided);
gemma-2B text decoder (18L, MQA) with prefix-LM masking (arXiv:2407.07726)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    mlp_kind="gated_gelu", attn_kind="prefix",
    tie_embeddings=True, scale_embedding=True,
    num_patches=256, patch_dim=1152,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512, num_patches=16, patch_dim=64,
    param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
