"""The LM model zoo of the port: the dense family's prefill so far
(``dense.py``), the model API (``model.py``) and the converters from the JAX
package's configs and parameter trees (``convert.py``)."""

from .convert import config_from_jax, params_from_jax
from .model import init_params, make_dummy_batch, model_flops_per_token, param_count, prefill_fn

__all__ = [
    "config_from_jax",
    "init_params",
    "make_dummy_batch",
    "model_flops_per_token",
    "param_count",
    "params_from_jax",
    "prefill_fn",
]
