"""deepseek-v3-671b [moe]: MLA, 3 dense prefix layers, 58 MoE layers with
1 shared + 256 routed experts (top-8), MTP depth-1 (arXiv:2412.19437).

Optimizer is Adafactor (factored 2nd moment): AdamW fp32 state for 671B
params does not fit a 256-chip v5e pod (see DESIGN.md §5).
Expert parallelism places one expert per device: expert axes ('data','model').
"""

from .base import ModelConfig, register

FULL = ModelConfig(
    arch="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128,  # nope head dim
    d_ff=18432,  # dense prefix layers' FFN
    vocab_size=129280,
    num_experts=256, top_k=8, d_ff_expert=2048, num_shared_experts=1,
    dense_prefix_layers=3, router_aux_weight=0.001, capacity_factor=1.25,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
    v_head_dim=128, use_mtp=True, mtp_weight=0.3,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", attn_block_q=512, optimizer="adafactor",
)

SMOKE = FULL.replace(
    num_layers=3, dense_prefix_layers=1, d_model=256,
    num_heads=4, num_kv_heads=4, head_dim=32,
    d_ff=512, d_ff_expert=128, num_experts=4, top_k=2, num_shared_experts=1,
    q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16, v_head_dim=32,
    vocab_size=512, param_dtype="float32", compute_dtype="float32",
    remat="none", attn_block_q=0,
)

register(FULL, SMOKE)
