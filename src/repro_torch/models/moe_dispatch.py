"""Mixture-of-Experts routing and dispatch, after the JAX package's
``models/moe_dispatch.py``.

  * ``dense``  — every expert on every token, combined by gate (the
                 reference's oracle; O(T·E) work, exact when nothing drops).
  * ``einsum`` — Mesh-TF-style one-hot capacity dispatch: exact up to
                 capacity drops; for small token counts (decode).
  * ``a2a``    — the reference's expert parallelism over a mesh. Without a
                 mesh the reference runs ``dense``, and so does the port
                 without a ``torch.distributed`` process group; with one it
                 raises (the exchange over ``torch.distributed`` is ROADMAP.md
                 Queue 1).

All share the router: softmax, top-k, renormalise, and the switch-style
load-balance auxiliary loss. The top k come from a stable descending sort,
so among equal probabilities the lower expert index comes first, as
``jax.lax.top_k`` orders them: ``torch.topk`` promises no order for ties,
and the order decides the einsum dispatch's slot positions and with them
which tokens the capacity drops.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig

__all__ = ["einsum_capacity", "moe_ffn", "route"]


def route(cfg: ModelConfig, x2d: torch.Tensor, router_w: torch.Tensor):
    """x2d ``(T, d)`` -> ``(gate_w (T, k) float32, gate_idx (T, k) int64,
    aux)``, the router in float32."""
    probs = torch.softmax(x2d.float() @ router_w.float(), dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_idx = gate_w[:, :cfg.top_k], gate_idx[:, :cfg.top_k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # load-balance aux: E * sum_e f_e * P_e
    E = cfg.num_experts
    f_e = F.one_hot(gate_idx, E).float().mean(dim=(0, 1))  # fraction routed, slot-averaged
    aux = E * torch.sum(f_e * probs.mean(dim=0))
    return gate_w, gate_idx, aux


def _expert_mlp(experts, xs):
    """xs ``(E, C, d)`` grouped per expert: the gated-SiLU MLP of each
    expert on its rows."""
    h = F.silu(torch.bmm(xs, experts["w_gate"])) * torch.bmm(xs, experts["w_in"])
    return torch.bmm(h, experts["w_out"])


def _moe_dense(cfg: ModelConfig, x2d, experts, gate_w, gate_idx):
    """Every expert on every token, ``(E, T, d)``, combined by the gates
    cast to the activations' dtype."""
    h = F.silu(torch.matmul(x2d, experts["w_gate"])) * torch.matmul(x2d, experts["w_in"])  # (E, T, f)
    y_all = torch.bmm(h, experts["w_out"])  # (E, T, d)
    onehot = F.one_hot(gate_idx, cfg.num_experts).to(x2d.dtype)  # (T, k, E)
    w = (gate_w.to(x2d.dtype)[..., None] * onehot).sum(1)  # (T, E)
    return torch.einsum("te,etd->td", w, y_all)


def einsum_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert of the einsum dispatch for ``tokens`` tokens."""
    return max(8, int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts) + 8)


def _moe_einsum(cfg: ModelConfig, x2d, experts, gate_w, gate_idx, capacity: int):
    """One-hot capacity dispatch: the (t, slot) pairs of each expert take
    its ``capacity`` slots in t-major order, the rest are dropped."""
    T, _ = x2d.shape
    E, k = cfg.num_experts, cfg.top_k
    onehot = F.one_hot(gate_idx, E).float()  # (T, k, E)
    flat = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flat, dim=0) - flat) * flat  # position within the expert if routed
    pos = pos.sum(-1).reshape(T, k).long()
    # a dropped pair gets the one-hot of slot `capacity`, which is cut off
    pos_oh = F.one_hot(pos.clamp_max(capacity), capacity + 1)[..., :capacity].float()  # (T, k, C)
    dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)  # (T, E, C) 0/1
    combine = torch.einsum("tk,tke,tkc->tec", gate_w.float(), onehot, pos_oh)
    xs = torch.einsum("tec,td->ecd", dispatch, x2d.float()).to(x2d.dtype)
    ys = _expert_mlp(experts, xs)  # (E, C, d)
    return torch.einsum("tec,ecd->td", combine, ys.float()).to(x2d.dtype)


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """p: ``{router (d, E), experts {w_gate, w_in, w_out} (E, ...)[, shared
    {...}]}``. x ``(B, S, d)`` -> ``(y (B, S, d), aux)``."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    gate_w, gate_idx, aux = route(cfg, x2d, p["router"])

    impl = cfg.moe_impl
    if impl == "a2a":
        if _distributed():
            raise NotImplementedError(
                "moe_impl='a2a' over torch.distributed is not ported yet (ROADMAP.md, Queue 1); without a "
                "process group it runs the dense dispatch, as the reference does without a mesh"
            )
        impl = "dense"
    if impl == "dense":
        y = _moe_dense(cfg, x2d, p["experts"], gate_w, gate_idx)
    elif impl == "einsum":
        y = _moe_einsum(cfg, x2d, p["experts"], gate_w, gate_idx, einsum_capacity(cfg, B * S))
    else:
        raise ValueError(cfg.moe_impl)

    if "shared" in p:  # deepseek-style always-on shared expert(s)
        sh = p["shared"]
        y = y + (F.silu(x2d @ sh["w_gate"]) * (x2d @ sh["w_in"])) @ sh["w_out"]
    return y.reshape(B, S, d), aux
