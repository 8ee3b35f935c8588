"""Converters from the JAX package's configs and parameter trees to the
port's. They take plain Python objects and numpy arrays, so the port imports
nothing of JAX; a caller turns a JAX tree into numpy first
(``jax.tree.map(np.asarray, params)``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ATTN_IMPL_FROM_JAX, ModelConfig
from ..core.torch_dp import resolve_device
from .dense import attn_pattern

__all__ = ["config_from_jax", "params_from_jax", "tensor_from_numpy"]


def config_from_jax(jcfg) -> ModelConfig:
    """The port's :class:`ModelConfig` with the fields of a JAX package
    config (any dataclass with the same field names); ``attn_impl`` is
    translated by :data:`repro_torch.configs.ATTN_IMPL_FROM_JAX`
    (``"xla"`` -> ``"plain"``, ``"pallas"`` -> ``"flash"``)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)}
    fields["attn_impl"] = ATTN_IMPL_FROM_JAX[fields["attn_impl"]]
    return ModelConfig(**fields)


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A tensor with a copy of the array's values, in its dtype (bfloat16
    arrays, which numpy holds as ``ml_dtypes.bfloat16``, keep their bits)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(x, fn) for k, x in tree.items()}
    return fn(tree)


def params_from_jax(cfg: ModelConfig, tree, device="cuda"):
    """The port's parameters from a JAX ``init_params`` tree of numpy arrays.

    The JAX layer stack carries leading ``(n_groups, period)`` axes on every
    leaf; entry ``[g, sub]`` becomes port layer ``g * period + sub``. Dtypes
    are kept; tensors go to ``device``.
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP.md, Queue 1)")
    dev = resolve_device(device)
    period = len(attn_pattern(cfg))
    n_groups = cfg.num_layers // period

    def to_t(a):
        return tensor_from_numpy(a, dev)

    params = {k: _map(x, to_t) for k, x in tree.items() if k != "layers"}
    params["layers"] = [
        _map(tree["layers"], lambda a, g=g, sub=sub: to_t(np.asarray(a)[g, sub]))
        for g in range(n_groups) for sub in range(period)
    ]
    return params
