"""The model zoo of the port, its six families: the dense family
(``dense.py``), the MoE family (``moe.py``, ``moe_dispatch.py``,
``mla.py``), the xLSTM family (``xlstm.py``) and the Zamba2 hybrid
(``hybrid.py``) on the SSM cells (``ssm.py``), the HuBERT encoder
(``encoder.py``) and the PaliGemma VLM (``vlm.py``) on the dense stack, with
their prefill, loss and decode, the model API (``model.py``) and the
converters from the JAX package's configs, parameter trees and caches
(``convert.py``)."""

from .convert import cache_from_jax, cache_to_jax, config_from_jax, params_from_jax
from .model import (
    active_param_count,
    decode_fn,
    expert_param_count,
    init_cache,
    fake_mode,
    init_params,
    input_specs,
    layer_stacks,
    loss_fn,
    make_dummy_batch,
    model_flops_per_token,
    param_count,
    prefill_fn,
    supports_mode,
)

__all__ = [
    "active_param_count",
    "cache_from_jax",
    "cache_to_jax",
    "config_from_jax",
    "decode_fn",
    "expert_param_count",
    "init_cache",
    "fake_mode",
    "init_params",
    "input_specs",
    "layer_stacks",
    "loss_fn",
    "make_dummy_batch",
    "model_flops_per_token",
    "param_count",
    "params_from_jax",
    "prefill_fn",
    "supports_mode",
]
