"""hubert-xlarge [audio]: encoder-only transformer 48L/1280d; conv waveform
frontend STUBBED — inputs are precomputed frame embeddings (arXiv:2106.07447)."""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    attn_kind="bidirectional", mlp_kind="gelu",
    frame_dim=512, mask_prob=0.08,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adamw",
)

SMOKE = FULL.replace(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
    vocab_size=64, frame_dim=32,
    param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
