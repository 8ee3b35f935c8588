"""The benchmark's frozen work counts and peaks.

Everything here is computed from a configuration's published widths and a
cell's shapes, never from what the program executes, so the numbers stay put
when an implementation changes:

* the model FLOPs of one training step (the numerator of ``mfu.train``):
  6 FLOPs a token for each weight the token uses (attention projections,
  the dense MLP, the router, the ``top_k`` experts it is routed to, the
  output head; not the embedding lookup, not the norm gains), plus 12·D
  FLOPs per (query, key) pair that the causal mask admits, per head and
  layer (4·D forward, 8·D backward). Remat's recomputation and the experts a
  token does not use are not counted;
* the least time of one flash-attention launch (forward 4·D FLOPs a pair,
  dQ 6·D, dK/dV 8·D, or its bytes read and written once over the HBM
  bandwidth, whichever is larger), after the conventions of the repository's
  ``chip_smoke.py`` (``attn_pairs``, ``flash_bound_ms``,
  ``flash_bwd_bound_ms``);
* the H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit), as
  ``repro_torch/launch/roofline.py::HW`` and ``chip_smoke.py`` state them.
"""

from __future__ import annotations

__all__ = [
    "PEAK_BF16_FLOPS",
    "PEAK_BYTES_PER_S",
    "attn_pairs",
    "flash_bound_s",
    "model_flops_per_step",
    "weights_per_token",
]

PEAK_BF16_FLOPS = 989e12  # dense bfloat16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3

# FLOPs per unmasked (query, key) pair and head dim, by flash launch
FLASH_FLOPS_PER_PAIR_D = {"fwd": 4, "dq": 6, "dkv": 8}


def attn_pairs(B: int, H: int, S: int) -> int:
    """(q, k) pairs that the causal mask admits in one attention layer at
    Sq = Sk = S."""
    return B * H * (S * (S + 1) // 2)


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def weights_per_token(m: dict) -> int:
    """Weights of the products one token passes through in a forward pass
    (module docstring), from the widths of model dict ``m``."""
    d, H, Hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], head_dim(m)
    attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
    if m["family"] == "dense":
        ffn = (3 if m["mlp_kind"].startswith("gated") else 2) * d * m["d_ff"]
    elif m["family"] == "moe":
        ffn = d * m["num_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
    else:
        raise ValueError(f"no work count for family {m['family']!r}")
    return m["num_layers"] * (attn + ffn) + d * m["vocab_size"]


def model_flops_per_step(m: dict, batch: int, seq_len: int) -> int:
    """Model FLOPs of one training step over ``batch`` rows of ``seq_len``
    predicted tokens (module docstring)."""
    tokens = batch * seq_len
    attn = 12 * head_dim(m) * attn_pairs(batch, m["num_heads"], seq_len) * m["num_layers"]
    return 6 * weights_per_token(m) * tokens + attn


def flash_bound_s(which: str, B: int, H: int, Hkv: int, S: int, D: int):
    """Least time of one causal bf16 flash launch (``which``: ``"fwd"``,
    ``"dq"`` or ``"dkv"``) at Sq = Sk = S: the larger of its FLOPs over the
    bf16 peak and its bytes over the HBM bandwidth. Bytes: forward q, k, v
    read, o written, lse (float32) written; dQ q, k, v, dO read, lse and
    delta (float32) read, dQ written; dK/dV the same reads, dK and dV
    written. Returns ``(seconds, "operations" | "bytes")``."""
    t_ops = FLASH_FLOPS_PER_PAIR_D[which] * D * attn_pairs(B, H, S) / PEAK_BF16_FLOPS
    q_like, kv_like = B * H * S * D, B * Hkv * S * D
    if which == "fwd":
        nbytes = 2 * (2 * q_like + 2 * kv_like) + 4 * B * H * S
    else:
        outs = q_like if which == "dq" else 2 * kv_like
        nbytes = 2 * (2 * q_like + 2 * kv_like + outs) + 8 * B * H * S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
