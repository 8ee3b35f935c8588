"""The frozen work counts of the DeepSeek-V3 cell, beside
:mod:`perfbench.work`'s, under its conventions: computed from the
configuration's published widths and the cell's shapes, never from what
the program executes.

* Model FLOPs of one training step (the numerator of ``mfu.train_v3``): 6
  FLOPs a token for each weight the token uses (MLA's projections, the
  dense MLP, the router's 256 outputs, the shared expert, ``top_k`` routed
  experts times the share ``num_experts_held / num_experts`` of them this
  card holds, the head; not the embedding lookup, not the norm gains),
  plus MLA's attention at its true head dims: ``6 * (Dqk + Dv)`` FLOPs per
  causal (query, key) pair, head and layer (``2 * (Dqk + Dv)`` forward,
  twice that backward), with ``Dqk`` the nope and rope dims and ``Dv`` v's.
  Remat's recomputation and the zero padding of v are not counted.
* The least time of one flash launch at MLA's true work: forward
  ``2 * (Dqk + Dv)`` FLOPs a pair, dQ ``4 * Dqk + 2 * Dv`` (S = QK^T again,
  dP = dO V^T, dQ = dS K), dK/dV ``4 * Dqk + 4 * Dv`` (S, dP, dV = P^T dO,
  dK = dS^T Q), or its bytes at the true dims (q and k at ``Dqk``, v, o and
  dO at ``Dv``) over the HBM bandwidth, whichever is larger. The kernels run
  on inputs padded to the 256 instance, so the padding shows as lost share.
"""

from __future__ import annotations

from .work import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, attn_pairs

__all__ = ["FLASH_FLOPS_PER_PAIR", "flash_bound_s", "head_dims", "model_flops_per_step", "weights_per_token"]


def head_dims(m: dict) -> tuple:
    """``(Dqk, Dv)`` of MLA's attention."""
    return m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"]


# FLOPs per unmasked (query, key) pair and head, by flash launch, from (Dqk, Dv)
FLASH_FLOPS_PER_PAIR = {"fwd": lambda dqk, dv: 2 * dqk + 2 * dv, "dq": lambda dqk, dv: 4 * dqk + 2 * dv,
                        "dkv": lambda dqk, dv: 4 * dqk + 4 * dv}


def weights_per_token(m: dict) -> int:
    """Weights of the products one token passes through in a forward pass
    (module docstring), from the widths of model dict ``m``."""
    d, H = m["d_model"], m["num_heads"]
    qr, kr = m["q_lora_rank"], m["kv_lora_rank"]
    nd, rd, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    mla = d * qr + qr * H * (nd + rd) + d * kr + kr * H * (nd + vd) + d * rd + H * vd * d
    dense = 3 * d * m["d_ff"]
    expert = 3 * d * m["d_ff_expert"]
    routed = m["top_k"] * m["num_experts_held"] * expert // m["num_experts"]
    moe = d * m["num_experts"] + routed + m["num_shared_experts"] * expert
    n_dense = m["dense_prefix_layers"]
    return m["num_layers"] * mla + n_dense * dense + (m["num_layers"] - n_dense) * moe + d * m["vocab_size"]


def model_flops_per_step(m: dict, batch: int, seq_len: int) -> int:
    """Model FLOPs of one training step over ``batch`` rows of ``seq_len``
    predicted tokens (module docstring)."""
    dqk, dv = head_dims(m)
    attn = 6 * (dqk + dv) * attn_pairs(batch, m["num_heads"], seq_len) * m["num_layers"]
    return 6 * weights_per_token(m) * batch * seq_len + attn


def flash_bound_s(which: str, m: dict, B: int, S: int):
    """Least time of one causal bf16 flash launch of MLA (``which``:
    ``"fwd"``, ``"dq"`` or ``"dkv"``) at Sq = Sk = S: the larger of its FLOPs
    at the true head dims over the bf16 peak and its bytes over the HBM
    bandwidth. Bytes: forward q, k, v read, o and lse (float32) written; dQ
    q, k, v, dO read, lse and delta (float32) read, dQ written; dK/dV the
    same reads, dK and dV written. Returns ``(seconds, "operations" |
    "bytes")``."""
    dqk, dv = head_dims(m)
    H = m["num_heads"]
    t_ops = FLASH_FLOPS_PER_PAIR[which](dqk, dv) * attn_pairs(B, H, S) / PEAK_BF16_FLOPS
    rows = B * H * S
    reads = rows * (2 * dqk + dv)  # q, k, v: MHA, one k and v head a q head
    if which == "fwd":
        nbytes = 2 * (reads + rows * dv) + 4 * rows
    else:
        outs = rows * dqk if which == "dq" else rows * (dqk + dv)
        nbytes = 2 * (reads + rows * dv + outs) + 8 * rows
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
