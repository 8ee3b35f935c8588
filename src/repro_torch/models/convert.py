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

__all__ = ["cache_from_jax", "cache_to_jax", "config_from_jax", "params_from_jax", "tensor_from_numpy"]


def config_from_jax(jcfg) -> ModelConfig:
    """The port's :class:`ModelConfig` with the fields of a JAX package
    config (any dataclass with the same field names); ``attn_impl`` is
    translated by :data:`repro_torch.configs.ATTN_IMPL_FROM_JAX`
    (``"xla"`` -> ``"plain"``, ``"pallas"`` -> ``"flash"``). The port's own
    fields, which the JAX package lacks, keep their defaults."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig) if hasattr(jcfg, f.name)}
    fields["attn_impl"] = ATTN_IMPL_FROM_JAX[fields["attn_impl"]]
    return ModelConfig(**fields)


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A tensor on ``device`` (the card unless the caller asks for the CPU)
    with a copy of the array's values, in its dtype (bfloat16 arrays, which
    numpy holds as ``ml_dtypes.bfloat16``, keep their bits)."""
    dev = resolve_device(device)
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(x, fn) for k, x in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(x, fn) for x in tree)
    return fn(tree)


def _merge_lead(a):
    """``a`` with its two leading axes merged into one."""
    a = np.asarray(a)
    return a.reshape((-1,) + a.shape[2:])


def _unstack(tree, n, to_t):
    """A stacked tree (leading ``(n,)`` on every leaf) as a list of ``n``
    per-layer trees."""
    return [_map(tree, lambda a, i=i: to_t(np.asarray(a)[i])) for i in range(n)]


# the top-level keys of each family's JAX parameter tree that hold stacked layers
_STACKED = {"dense": ("layers",), "encoder": ("layers",), "vlm": ("layers",), "moe": ("moe_layers", "dense_layers"),
            "ssm": ("groups",), "hybrid": ("mamba_groups",)}


def params_from_jax(cfg: ModelConfig, tree, device="cuda"):
    """The port's parameters from a JAX ``init_params`` tree of numpy arrays
    (or a gradient tree of the same shape).

    Dense, encoder and vlm: the JAX layer stack carries leading ``(n_groups,
    period)`` axes on every leaf; entry ``[g, sub]`` becomes port layer ``g *
    period + sub``; the other leaves (the encoder's ``frame_proj``,
    ``mask_emb`` and ``head``, the VLM's ``patch_proj``) are not stacked.
    MoE: ``moe_layers`` and ``dense_layers`` are stacked on ``(n,)`` and
    become lists; ``mtp`` is not stacked. ssm (xLSTM): ``groups/mlstm``
    ``(n_groups, period - 1)`` becomes the list ``mlstm`` (block ``g *
    (period - 1) + j``), ``groups/slstm`` ``(n_groups,)`` the list
    ``slstm``. hybrid (Zamba2): ``mamba_groups`` ``(n_groups, period)``
    becomes the list ``mamba`` (block ``g * period + j``); ``shared`` is not
    stacked. Dtypes are kept; tensors go to ``device``. An unknown family
    raises ``ValueError``.
    """
    if cfg.family not in _STACKED:
        raise ValueError(cfg.family)
    stacked = _STACKED[cfg.family]
    dev = resolve_device(device)

    def to_t(a):
        return tensor_from_numpy(a, dev)

    params = {k: _map(x, to_t) for k, x in tree.items() if k not in stacked}
    if stacked == ("layers",):
        params["layers"] = _unstack(_map(tree["layers"], _merge_lead), cfg.num_layers, to_t)
    elif cfg.family == "ssm":
        G = cfg.num_layers // cfg.slstm_every
        params["mlstm"] = _unstack(_map(tree["groups"]["mlstm"], _merge_lead), G * (cfg.slstm_every - 1), to_t)
        params["slstm"] = _unstack(tree["groups"]["slstm"], G, to_t)
    elif cfg.family == "hybrid":
        params["mamba"] = _unstack(_map(tree["mamba_groups"], _merge_lead), cfg.num_layers, to_t)
    else:
        params["moe_layers"] = _unstack(tree["moe_layers"], cfg.num_layers - cfg.dense_prefix_layers, to_t)
        if cfg.dense_prefix_layers:
            params["dense_layers"] = _unstack(tree["dense_layers"], cfg.dense_prefix_layers, to_t)
    return params


def cache_from_jax(cfg: ModelConfig, cache, device="cuda"):
    """The port's decode cache from a JAX ``init_cache``/``decode_fn`` cache
    of numpy arrays. Dense: ``(k, v)`` of ``(n_groups, period, B, S, Hkv,
    hd)`` becomes ``(L, B, S, Hkv, hd)`` with layer ``g * period + sub``;
    vlm: as dense. MoE: ``{"moe"[, "dense"]}`` keeps its layout (pairs
    stacked on ``(n,)``; MLA's ``(c_kv, k_rope)``). ssm: ``{"mlstm": (conv, (S, n, m)), "slstm":
    (c, n, m, h)}``, the mLSTM leaves' ``(n_groups, period - 1)`` axes merged
    into one; hybrid: ``{"mamba": (conv, ssd), "attn": (k, v)}``, the Mamba2
    leaves' ``(n_groups, period)`` axes merged into one. The encoder has no
    cache: ``None``."""
    if cfg.family == "encoder":
        return None
    dev = resolve_device(device)

    def to_t(a):
        return tensor_from_numpy(a, dev)

    if cfg.family in ("dense", "vlm"):
        return tuple(to_t(_merge_lead(a)) for a in cache)
    if cfg.family == "moe":
        return {k: tuple(to_t(a) for a in pair) for k, pair in cache.items()}
    if cfg.family == "ssm":
        return {"mlstm": _map(cache["mlstm"], lambda a: to_t(_merge_lead(a))), "slstm": _map(cache["slstm"], to_t)}
    if cfg.family == "hybrid":
        return {"mamba": _map(cache["mamba"], lambda a: to_t(_merge_lead(a))), "attn": _map(cache["attn"], to_t)}
    raise ValueError(cfg.family)


def cache_to_jax(cfg: ModelConfig, cache):
    """The inverse of :func:`cache_from_jax`, as numpy arrays (float32 and
    the other numpy dtypes; a bfloat16 cache is widened to float32)."""
    def to_np(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def split_lead(period):
        return lambda t: to_np(t).reshape((t.shape[0] // period, period) + tuple(t.shape[1:]))

    if cfg.family == "encoder":
        return None
    if cfg.family in ("dense", "vlm"):
        return tuple(map(split_lead(len(attn_pattern(cfg))), cache))
    if cfg.family == "moe":
        return {k: tuple(to_np(t) for t in pair) for k, pair in cache.items()}
    if cfg.family == "ssm":
        return {"mlstm": _map(cache["mlstm"], split_lead(cfg.slstm_every - 1)), "slstm": _map(cache["slstm"], to_np)}
    if cfg.family == "hybrid":
        return {"mamba": _map(cache["mamba"], split_lead(cfg.shared_attn_every)), "attn": _map(cache["attn"], to_np)}
    raise ValueError(cfg.family)
