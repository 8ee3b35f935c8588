"""Model/run configuration dataclasses + the architecture registry.

The fields are those of the JAX package's ``configs/base.py`` that the
six families (dense, MoE with MLA and MTP, the xLSTM ``ssm`` family, the
Zamba2 ``hybrid`` family, the HuBERT ``encoder`` and the PaliGemma ``vlm``
with their stub frontends) and the serving path read, with the reference's
defaults. Dtypes stay strings and
:meth:`ModelConfig.pdtype`/:meth:`ModelConfig.cdtype` map them to torch
dtypes. One field takes port names:

* ``attn_impl``: ``"plain"`` (the JAX package's ``"xla"``: the dense
  einsum/softmax formulation, query-blocked when ``attn_block_q > 0``) or
  ``"flash"`` (its ``"pallas"``: the hand-written flash-attention kernel,
  ``kernels/csrc/flash_fwd.cu``). :data:`ATTN_IMPL_FROM_JAX` is the mapping;
  :func:`repro_torch.models.convert.config_from_jax` applies it.

Fields the JAX package lacks, whose defaults keep every registered arch as
the reference runs it: DeepSeek-V3's published router and the chip's share
of its experts (``router_score`` ... ``first_expert_held``, read by
:mod:`repro_torch.models.moe_dispatch`), MLA in the dense prefix layers
(``dense_prefix_mla``, :mod:`repro_torch.models.moe`), and AdamW's second
moment decay and weight decay (``adam_b2``, ``weight_decay``,
:func:`repro_torch.launch.build_train_step`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "ATTN_IMPL_FROM_JAX",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "list_archs",
    "register",
    "torch_dtype",
]

ATTN_IMPL_FROM_JAX = {"xla": "plain", "pallas": "flash"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"`` ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # dense variants
    mlp_kind: str = "gated_silu"  # gated_silu | gated_gelu | gelu | squared_relu
    attn_kind: str = "causal"  # causal | local_global (gemma2) | bidirectional | prefix
    window: int = 4096  # sliding window for local layers
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    scale_embedding: bool = False  # gemma family: h *= sqrt(d_model)
    long_context: bool = False  # serving mode: global attn layers fall back to sliding window
    attn_block_q: int = 0  # 0 = full attention matrix; >0 = query-blocked loop (plain route)
    attn_impl: str = "plain"  # plain | flash (see the module docstring)
    moe_impl: str = "dense"  # dense | einsum | a2a (set per shape by the launcher) | held

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1  # every layer is MoE except the first `dense_prefix_layers`
    dense_prefix_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # DeepSeek-V3 (arXiv:2412.19437 §2.1.2): sigmoid affinities, selection
    # limited to the router_groups_kept of router_groups expert groups, gates
    # normalised over the chosen experts and scaled by routed_scale
    router_score: str = "softmax"  # softmax | sigmoid
    router_groups: int = 0  # 0: no group limit
    router_groups_kept: int = 0
    routed_scale: float = 1.0
    # moe_impl="held": this layer holds the weights of the routed experts
    # [first_expert_held, first_expert_held + num_experts_held) of num_experts
    num_experts_held: int = 0  # 0: all of them
    first_expert_held: int = 0

    # MLA (deepseek-v3)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0
    dense_prefix_mla: bool = False  # MLA in the dense prefix layers too (DeepSeek-V3), else MHA
    use_mtp: bool = False
    mtp_weight: float = 0.3

    # SSM / xLSTM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    slstm_every: int = 0  # xlstm: every k-th layer is sLSTM
    shared_attn_every: int = 0  # zamba2: shared attention block period
    chunk_size: int = 256

    # encoder (hubert) / vlm (paligemma) stub frontends
    frame_dim: int = 0  # audio frame embedding dim
    mask_prob: float = 0.08
    num_patches: int = 0  # vision patches
    patch_dim: int = 0

    # numerics / training
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"  # none | full | dots
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    adam_b2: float = 0.999
    weight_decay: float = 0.0  # AdamW's decoupled weight decay

    # serving
    max_cache_len: int = 0

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPL_FROM_JAX.values():
            raise ValueError(
                f"attn_impl must be one of {sorted(ATTN_IMPL_FROM_JAX.values())}, got {self.attn_impl!r} "
                f"(the JAX names map as {ATTN_IMPL_FROM_JAX})"
            )
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got {self.remat!r}")
        if self.router_score not in ("softmax", "sigmoid"):
            raise ValueError(f"router_score must be 'softmax' or 'sigmoid', got {self.router_score!r}")
        if self.router_score == "softmax" and (self.router_groups or self.routed_scale != 1.0):
            raise ValueError("router_groups and routed_scale belong to the sigmoid router")
        if self.dense_prefix_mla and not self.use_mla:
            raise ValueError("dense_prefix_mla needs use_mla")
        held = self.experts_held
        if not 0 <= self.first_expert_held <= self.num_experts - held:
            raise ValueError(f"experts [{self.first_expert_held}, {self.first_expert_held + held}) are not among "
                             f"the {self.num_experts} experts")

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def experts_held(self) -> int:
        """The routed experts whose weights a MoE layer holds."""
        return self.num_experts_held or self.num_experts

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

_REGISTRY = {}


def register(full_cfg: ModelConfig, smoke_cfg: ModelConfig):
    _REGISTRY[full_cfg.arch] = (full_cfg, smoke_cfg)
    return full_cfg


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    from . import _load_all

    _load_all()
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch][1 if smoke else 0]


def list_archs():
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
