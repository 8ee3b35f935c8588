"""Model/run configuration dataclasses + the architecture registry.

The fields are those of the JAX package's ``configs/base.py`` that the dense
prefill and training steps read; each later slice (MoE, SSM, serving) adds
its own fields with the code that reads them. Dtypes stay strings and
:meth:`ModelConfig.pdtype`/:meth:`ModelConfig.cdtype` map them to torch
dtypes. One field takes port names:

* ``attn_impl``: ``"plain"`` (the JAX package's ``"xla"``: the dense
  einsum/softmax formulation, query-blocked when ``attn_block_q > 0``) or
  ``"flash"`` (its ``"pallas"``: the hand-written flash-attention kernel,
  ``kernels/csrc/flash_fwd.cu``). :data:`ATTN_IMPL_FROM_JAX` is the mapping;
  :func:`repro_torch.models.convert.config_from_jax` applies it.
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

    # numerics / training
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: str = "none"  # none | full | dots (dots is not ported: no config uses it)
    optimizer: str = "adamw"
    learning_rate: float = 3e-4

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPL_FROM_JAX.values():
            raise ValueError(
                f"attn_impl must be one of {sorted(ATTN_IMPL_FROM_JAX.values())}, got {self.attn_impl!r} "
                f"(the JAX names map as {ATTN_IMPL_FROM_JAX})"
            )
        if self.remat not in ("none", "full", "dots"):
            raise ValueError(f"remat must be 'none', 'full' or 'dots', got {self.remat!r}")

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

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
        raise KeyError(
            f"arch {arch!r} is not in the port (the JAX package's other archs come with later "
            f"slices, ROADMAP.md Queue 1); ported: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[arch][1 if smoke else 0]


def list_archs():
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
