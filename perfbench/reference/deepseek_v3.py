"""The plain reference of the DeepSeek-V3 training cell: the published
model's loss, its gradients and AdamW steps, in plain PyTorch.

It follows the V3 report (arXiv:2412.19437) as the configuration file
states it (``perfbench/configs/deepseek-v3.json``, ``model`` and ``train``):

* token embedding; per layer a pre-norm block: RMSNorm scaled by
  ``1 + gain``, then Multi-head Latent Attention (§2.1.1): ``c_q =
  RMSNorm(x W_dq)``, ``q = c_q W_uq`` split into ``qk_nope_head_dim``
  columns and ``qk_rope_head_dim`` rotated ones; ``c_kv = RMSNorm(x
  W_dkv)``, ``k_nope = c_kv W_uk``, ``v = c_kv W_uv``, one rotated key
  ``x W_kr`` shared by the heads; rotary embeddings on split halves (base
  ``rope_base``, no YaRN); causal softmax attention with the scale
  ``(qk_nope_head_dim + qk_rope_head_dim) ** -0.5``, computed in blocks of
  queries; the output projection; added to the residual;
* then a pre-norm feed-forward, added to the residual: the gated-SiLU MLP
  in the ``dense_prefix_layers`` leading layers; after them the MoE layer
  (§2.1.2): affinities ``s = sigmoid(u W_r)`` over all ``num_experts``
  experts, the ``top_k`` chosen on ``s + b`` (``b`` the layer's
  selection-only bias) among the ``router_groups_kept`` of
  ``router_groups`` groups of consecutive experts whose two largest biased
  scores sum highest (ties to the lower index), gates the unbiased ``s`` of
  the chosen experts over their sum times ``routed_scale``; each token runs
  the chosen experts this card holds (``num_experts_held`` from
  ``first_expert_held``), each a gated-SiLU MLP, summed by its gates (the
  other experts' part lies on other cards and is left out), plus the shared
  expert; the sequence-wise balance term (§2.1.3) ``E * sum_e f_e * P_e``
  per sequence (``f_e`` its share of the (token, choice) pairs routed to
  ``e``, ``P_e`` the mean of ``s_e / sum_j s_j``), averaged over the
  sequences and the layers, added with weight ``router_aux_weight``;
* a final RMSNorm and an untied output head; the mean next-token negative
  log-likelihood;
* AdamW at the rounding points of :func:`perfbench.reference.decoder.adamw_update`,
  with the configuration's ``b2`` and weight decay.

Forced routing: given the experts the program chose (``choices``, one
``(T', top_k)`` tensor a MoE layer and step for the first ``T'`` tokens),
the reference computes everything itself in float32 but routes those
tokens to the program's experts: near-tied top-k choices flip on bf16
rounding, and a flipped expert would move the gradients far more than the
rounding that flipped it. It also makes its own choice and counts the
(token, layer) pairs whose set of experts equals the program's:
``route_agreement``, which a wrong router fails.

Every product, norm, softmax and sum runs in float32 with TF32 off
(``precision="float32"``); ``precision="fp8"`` is the benchmark's control
(:mod:`perfbench.reference.decoder`'s float8 products). Faults the check
has to catch: ``half_batch=True`` (the loss over half of the positions) and
``route_fault="no_bias"`` (the bias left out of the selection). Each layer
runs under ``torch.utils.checkpoint``, and so does each block of queries,
so the reference fits beside its state on one card. It imports nothing of
the program under test and takes none of its tensors: it makes its
starting point from the seed (:mod:`perfbench.weights_v3`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import weights as W
from .. import weights_v3 as WV
from .decoder import _float32_products, _Ops, _rms, _rope, adamw_update

__all__ = ["ROUTE_FAULTS", "follow", "loss", "select"]

ROUTE_FAULTS = ("no_bias",)
# queries a block of the attention, each block recomputed in the backward pass
_BLOCK_Q = 512


def _attend_block(ops, q, k, v, q0: int, scale: float):
    """Causal attention of the queries ``q (B, H, n, Dqk)`` at positions
    ``q0 ..`` over the keys ``0 .. q0 + n - 1``."""
    n, Sk = q.shape[2], k.shape[2]
    scores = ops.mm(q, k.transpose(-1, -2)) * scale
    causal = torch.arange(Sk, device=q.device)[None, :] <= (q0 + torch.arange(n, device=q.device))[:, None]
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return ops.mm(probs, v)


def _mla(ops, m, p, x, sin, cos):
    B, S, d = x.shape
    H, eps = m["num_heads"], m["rms_norm_eps"]
    nd, rd, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]

    def heads(a, w, n):
        return ops.mm(a, w.float().reshape(w.shape[0], H * n)).view(B, S, H, n).transpose(1, 2)  # (B, H, S, n)

    cq = _rms(ops.mm(x, p["w_dq"].float()), p["q_ln"], eps)
    ckv = _rms(ops.mm(x, p["w_dkv"].float()), p["kv_ln"], eps)
    q = heads(cq, p["w_uq"], nd + rd)
    k_nope, v = heads(ckv, p["w_uk"], nd), heads(ckv, p["w_uv"], vd)
    k_rope = _rope(ops.mm(x, p["w_kr"].float())[:, None], sin, cos)  # (B, 1, S, rd)
    q = torch.cat([q[..., :nd], _rope(q[..., nd:], sin, cos)], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, H, S, rd)], dim=-1)
    scale = (nd + rd) ** -0.5
    out = torch.cat([checkpoint(_attend_block, ops, q[:, :, i:i + _BLOCK_Q], k[:, :, :i + _BLOCK_Q],
                                v[:, :, :i + _BLOCK_Q], i, scale, use_reentrant=False)
                     for i in range(0, S, _BLOCK_Q)], dim=2)
    return ops.mm(out.transpose(1, 2).reshape(B, S, H * vd), p["wo"].float().reshape(H * vd, d))


def _mlp(ops, x, w):
    return ops.mm(F.silu(ops.mm(x, w["w_gate"].float())) * ops.mm(x, w["w_in"].float()), w["w_out"].float())


def select(m: dict, scores: torch.Tensor) -> torch.Tensor:
    """The ``top_k`` experts of each row of ``scores (T, E)`` within the
    kept groups (module docstring), ``(T, top_k)`` int64; ties to the lower
    index."""
    T, E = scores.shape
    G, kept = m["router_groups"], m["router_groups_kept"]
    g = scores.reshape(T, G, E // G)
    group_score = torch.sort(g, dim=-1, descending=True, stable=True).values[..., :2].sum(-1)
    groups = torch.sort(group_score, dim=-1, descending=True, stable=True).indices[:, :kept]
    allowed = torch.zeros(T, G, dtype=torch.bool, device=scores.device).scatter(1, groups, True)
    masked = torch.where(allowed[..., None], g, torch.full_like(g, float("-inf"))).reshape(T, E)
    return torch.sort(masked, dim=-1, descending=True, stable=True).indices[:, :m["top_k"]]


def _moe(ops, m, p, x, bias, forced, route_fault):
    """``(y, aux, own)``: the held experts' and the shared expert's output
    on ``x (B, S, d)``, the balance term, and the reference's own choice
    ``(T, top_k)``; the tokens that ``forced`` covers are routed by it."""
    B, S, d = x.shape
    E, k = m["num_experts"], m["top_k"]
    x2 = x.reshape(B * S, d)
    s = torch.sigmoid(ops.mm(x2, p["router"].float()))
    with torch.no_grad():
        own = select(m, s if route_fault == "no_bias" else s + bias)
        chosen = own if forced is None else torch.cat([forced, own[forced.shape[0]:]])
    gate = s.gather(1, chosen)
    gate = gate / gate.sum(-1, keepdim=True) * m["routed_scale"]
    f = F.one_hot(chosen, E).float().reshape(B, S, k, E).mean(dim=(1, 2))
    share = (s / s.sum(-1, keepdim=True)).reshape(B, S, E).mean(dim=1)
    aux = (E * (f * share).sum(-1)).mean()
    ex = p["experts"]
    y = _mlp(ops, x2, p["shared"])
    first = m["first_expert_held"]
    for e in range(m["num_experts_held"]):
        rows, slot = (chosen == first + e).nonzero(as_tuple=True)
        if rows.numel():
            ye = _mlp(ops, x2[rows], {n: ex[n][e] for n in ("w_gate", "w_in", "w_out")})
            y = y.index_add(0, rows, ye * gate[rows, slot, None])
    return y.reshape(B, S, d), aux, own


def loss(params, biases, m: dict, tokens: torch.Tensor, *, forced=None, own=None, precision: str = "float32",
         half_batch: bool = False, route_fault=None):
    """The training objective of ``tokens (B, S + 1)``, float32: the mean
    negative log-likelihood of ``tokens[:, 1:]`` given ``tokens[:, :-1]``
    plus the balance term. ``params``: the tree of
    :func:`perfbench.weights_v3.split` (leaves used in float32); ``biases``:
    one float32 ``(E,)`` a MoE layer; ``forced``: the program's choices, one
    ``(T', top_k)`` a MoE layer, or ``None``; ``own``: a list that gets the
    reference's own choices, one a MoE layer."""
    if route_fault not in (None, *ROUTE_FAULTS):
        raise ValueError(f"route_fault must be None or one of {ROUTE_FAULTS}, got {route_fault!r}")
    ops = _Ops(precision)
    eps = m["rms_norm_eps"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    B, S = inp.shape
    half = m["qk_rope_head_dim"] // 2
    pos = torch.arange(S, device=tokens.device, dtype=torch.float32)
    freqs = m["rope_base"] ** (-torch.arange(half, device=tokens.device, dtype=torch.float32) / half)
    ang = pos[:, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    h = params["emb"].float()[inp]

    def dense_layer(h, p):
        h = h + _mla(ops, m, p["attn_mla"], _rms(h, p["ln1"], eps), sin, cos)
        return h + _mlp(ops, _rms(h, p["ln2"], eps), p["mlp"])

    def moe_layer(h, p, bias, forced_l):
        h = h + _mla(ops, m, p["attn_mla"], _rms(h, p["ln1"], eps), sin, cos)
        y, aux, own_l = _moe(ops, m, p["moe"], _rms(h, p["ln2"], eps), bias, forced_l, route_fault)
        return h + y, aux, own_l

    for p in params.get("dense_layers", []):
        h = checkpoint(dense_layer, h, p, use_reentrant=False)
    auxes = []
    for i, (p, bias) in enumerate(zip(params["moe_layers"], biases, strict=True)):
        h, aux, own_l = checkpoint(moe_layer, h, p, bias, None if forced is None else forced[i], use_reentrant=False)
        auxes.append(aux)
        if own is not None:
            own.append(own_l)
    logits = ops.mm(_rms(h, params["ln_f"], eps), params["lm_head"].float())
    if half_batch:  # the fault: half of the batch left out, the mean over the rest
        if B > 1:
            logits, tgt = logits[: B // 2], tgt[: B // 2]
        else:
            logits, tgt = logits[:, : S // 2], tgt[:, : S // 2]
    out = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1))
    return out + m["router_aux_weight"] * torch.stack(auxes).mean()


def _agree(own, forced) -> tuple:
    """``(pairs agreeing, pairs)``: the (token, layer) pairs of ``forced``
    whose set of experts equals the reference's own choice."""
    agree = total = 0
    for o, f in zip(own, forced, strict=True):
        n = f.shape[0]
        agree += int((o[:n].sort(dim=-1).values == f.sort(dim=-1).values).all(dim=-1).sum())
        total += n
    return agree, total


def follow(m: dict, hp: dict, seed: int, batches, device, *, choices=None, precision: str = "float32",
           half_batch: bool = False, route_fault=None) -> dict:
    """Training steps from the seed's starting point, one per batch of
    ``batches`` (each ``(B, S + 1)``): ``{"losses", "grad_norms",
    "change_norms", "choices", "route_agreement"}``. The norms are per
    parameter leaf of :func:`perfbench.weights_v3.param_layout`, float32 on
    the CPU: the first step's gradient as the optimizer gets it and the
    parameters' change over all the steps. ``choices``: the program's chosen
    experts, ``choices[step][layer]``, which the reference is forced to
    (module docstring), or ``None``; ``"choices"`` holds the reference's
    own in the same form, and ``"route_agreement"`` the share of the forced
    (token, layer) pairs on which they agree (``None`` without
    ``choices``)."""
    lay = WV.layout(m)
    pdtype = getattr(torch, m["param_dtype"])
    flat = W.make_flat(lay, seed, device, pdtype)
    keep = [i for i, e in enumerate(lay) if e[0][0] != WV.BIAS]
    play = [lay[i] for i in keep]
    all_leaves = W.views(lay, flat)
    _, biases = WV.split(lay, all_leaves)
    leaves = [all_leaves[i] for i in keep]
    mu = [torch.zeros_like(x, dtype=getattr(torch, hp["mu_dtype"])) for x in leaves]
    nu = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
    losses, grad_norms, own_all, agree, total = [], None, [], 0, 0
    with _float32_products():
        for step, tokens in enumerate(batches, start=1):
            forced = None if choices is None else choices[step - 1]
            own = []
            xs = [x.detach().requires_grad_() for x in leaves]
            with torch.enable_grad():
                value = loss(W.tree(play, xs), biases, m, tokens, forced=forced, own=own, precision=precision,
                             half_batch=half_batch, route_fault=route_fault)
                grads = torch.autograd.grad(value, xs)
            losses.append(float(value.detach()))
            own_all.append(own)
            if forced is not None:
                a, t = _agree(own, forced)
                agree, total = agree + a, total + t
            if step == 1:
                grad_norms = torch.stack([g.float().norm() for g in grads]).cpu()
            with torch.no_grad():
                for x, g, a_, b_ in zip(leaves, grads, mu, nu):
                    adamw_update(x, g, a_, b_, step, hp)
            del xs, grads, value
    del mu, nu
    with torch.no_grad():
        start = W.views(lay, W.make_flat(lay, seed, device, pdtype))
        change = torch.stack([(x.float() - start[i].float()).norm() for i, x in zip(keep, leaves)]).cpu()
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "choices": own_all,
            "route_agreement": agree / total if total else None}
