"""gemma2-2b [dense]: local/global alternating attention, logit softcaps,
post-norms, head_dim=256, tied embeddings (arXiv:2408.00118)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    head_dim=256, d_ff=9216, vocab_size=256000,
    mlp_kind="gated_gelu", attn_kind="local_global", window=4096,
    attn_softcap=50.0, logit_softcap=30.0,
    tie_embeddings=True, scale_embedding=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    attn_block_q=512,
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, window=32,
    param_dtype="float32", compute_dtype="float32",
    attn_block_q=0,
)

register(FULL, SMOKE)
