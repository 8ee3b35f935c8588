"""Shared neural building blocks, ported from the JAX package's
``models/layers.py`` (plain PyTorch, params as nested dicts of tensors).

Conventions as there: activations in the config's compute dtype with float32
normalisation and softmax; heads laid out ``(B, S, H, D)``; weight names
stable (``wq``, ``w_in`` ...), so :mod:`repro_torch.models.convert` maps the
JAX parameter tree one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention

__all__ = [
    "apply_rope",
    "attention",
    "gelu",
    "make_rope",
    "mlp_act",
    "mlp_gated",
    "rms_norm",
    "softcap",
    "squared_relu",
]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + gamma)`` with the variance in float32, cast back
    to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: ``cap * tanh(x / cap)`` in float32."""
    return cap * torch.tanh(x.float() / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def make_rope(positions: torch.Tensor, head_dim: int, base: float = 10000.0):
    """Returns (sin, cos) of shape ``positions.shape + (head_dim // 2,)``."""
    half = head_dim // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: ``(..., S, H, D)``; sin/cos: ``(..., S, D/2)`` broadcast over heads.
    Rotates split halves (not interleaved pairs)."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    s = sin[..., None, :]  # add the head axis
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA/MQA, causal / sliding-window / prefix-LM / bidirectional,
# optional logit softcap)
# ---------------------------------------------------------------------------


def _build_mask(q_pos, kv_pos, kind: str, window: int = 0, prefix_len=None):
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    if kind == "bidirectional":
        return torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if kind == "causal":
        return kp <= qp
    if kind == "sliding":
        return (kp <= qp) & (kp > qp - window)
    if kind == "prefix":
        pl = 0 if prefix_len is None else prefix_len  # None at decode: pure causal
        return (kp <= qp) | (kp < pl)
    raise ValueError(kind)


def _flash_route(q, k, v, kind, prefix_len, kv_valid) -> bool:
    """The reference's conditions for the kernel route
    (``models/layers.py::attention``) that name features the kernel lacks: a
    prefix mask, a cache mask, ``Sq != Sk``, ``D != Dv``. The reference's
    length conditions (``Sq >= 128``, ``Sq % 128 == 0``) are dropped with its
    fault: there the kernel gets 512-row blocks and a grid of ``Sq // 512``,
    so for ``Sq % 512 != 0`` the rows past the last whole block are never
    written. This kernel masks ragged tiles itself and computes every row of
    every length."""
    return (
        kind in ("causal", "sliding", "bidirectional")
        and prefix_len is None and kv_valid is None
        and q.shape[1] == k.shape[1]
        and q.shape[-1] == v.shape[-1]
    )


def attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, Dv)
    *,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    kind: str = "causal",
    window: int = 0,
    prefix_len: Optional[torch.Tensor] = None,
    attn_softcap: float = 0.0,
    kv_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool: cache validity
    scale: Optional[float] = None,
    block_q: int = 0,
    impl: str = "plain",
) -> torch.Tensor:
    """Grouped-query attention. Returns ``(B, Sq, H, Dv)``.

    ``impl="flash"`` routes full self-attention (causal / sliding /
    bidirectional, no prefix, no cache mask, ``Sq == Sk`` of any length,
    ``D == Dv``) through the flash-attention kernel
    (:func:`repro_torch.kernels.flash_attention.flash_attention`), whose
    output carries a gradient through the backward kernels; everything else
    takes the plain route. ``block_q`` does not apply to the kernel, whose q
    tile is fixed.

    Plain route: ``block_q > 0`` loops over query blocks so the score tensor
    is bounded at ``(B, H, block_q, Sk)`` (exact: each block sees the full
    key row); otherwise one dense einsum/softmax, with the probabilities cast
    to v's dtype before the value product, as the reference does.
    """
    B, Sq, H, D = q.shape
    if impl == "flash" and _flash_route(q, k, v, kind, prefix_len, kv_valid):
        o, _ = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kind, window, attn_softcap, scale
        )
        return o.transpose(1, 2)
    if impl not in ("plain", "flash"):
        raise ValueError(f"impl must be 'plain' or 'flash', got {impl!r}")
    if block_q and Sq > block_q:
        outs = [
            attention(
                q[:, i:i + block_q], k, v, q_pos=q_pos[i:i + block_q], kv_pos=kv_pos, kind=kind,
                window=window, prefix_len=prefix_len, attn_softcap=attn_softcap,
                kv_valid=kv_valid, scale=scale, block_q=0,
            )
            for i in range(0, Sq, block_q)
        ]
        return torch.cat(outs, dim=1)
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf = (q * scale).float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if attn_softcap:
        logits = softcap(logits, attn_softcap)
    mask = _build_mask(q_pos, kv_pos, kind, window, prefix_len)[None, None, None]  # (1, 1, 1, Sq, Sk)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    r = torch.relu(x)
    return r * r


def mlp_gated(params, x, act=F.silu):
    """SwiGLU-style: ``(act(x W_gate) * x W_in) W_out``."""
    h = act(x @ params["w_gate"]) * (x @ params["w_in"])
    return h @ params["w_out"]


def mlp_act(params, x, act):
    """Plain two-matrix MLP with activation (gelu / squared-relu / ...)."""
    return act(x @ params["w_in"]) @ params["w_out"]
