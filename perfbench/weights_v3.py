"""The parameters of the DeepSeek-V3 cell, made on the card from ``--seed``
as :mod:`perfbench.weights` makes the other cells' (one flat buffer, a few
large draws, the leaves views of it), with one departure: the embedding
table is drawn at standard deviation 1 (``fan_in`` 1, as ``nn.Embedding``
draws it), not ``1 / sqrt(d_model)``. At the smaller scale the residual
stream of a random model is dominated, after the first attention, by its
running mean over the sequence, which every token shares; the router then
sends most tokens of a sequence to the same few experts (on the card one
held expert took all 4,096 tokens, and the held experts' load a layer
varied 1.7-4.0 thousand pairs by seed against a balanced 1,024), unlike a
trained V3, whose bias keeps the load balanced. A token's own embedding,
at norm about sqrt(d_model), keeps the routing near balance.

:func:`layout` names every leaf by its path in the port's parameter tree of
the published model (``models/moe.py`` with MLA in every layer, the dense
prefix layers' gated-SiLU MLP, and a MoE layer holding ``num_experts_held``
of its routed experts beside the router's full width and the shared
expert), and, last, each MoE layer's selection-only router bias under
``("router_bias", i)``. The bias is state outside the parameters: the
optimizer never sees it and the step never writes it (the published bias
update speed 0), so :func:`split` hands it over apart, in float32. It is
drawn with the weights, a normal truncated at two standard deviations
times ``1 / sqrt(d_model)``.
"""

from __future__ import annotations

import torch

from . import weights as W

__all__ = ["BIAS", "flat_and_split", "layout", "param_layout", "split"]

BIAS = "router_bias"


def _mla(m: dict, pre: tuple) -> list:
    d, H = m["d_model"], m["num_heads"]
    qr, kr = m["q_lora_rank"], m["kv_lora_rank"]
    nd, rd, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    a = pre + ("attn_mla",)
    return [(a + ("w_dq",), (d, qr), d), (a + ("q_ln",), (qr,), 0), (a + ("w_uq",), (qr, H, nd + rd), qr),
            (a + ("w_dkv",), (d, kr), d), (a + ("kv_ln",), (kr,), 0), (a + ("w_uk",), (kr, H, nd), kr),
            (a + ("w_uv",), (kr, H, vd), kr), (a + ("w_kr",), (d, rd), d), (a + ("wo",), (H, vd, d), H * vd)]


def _gated(pre: tuple, d: int, f: int) -> list:
    return [(pre + ("w_gate",), (d, f), d), (pre + ("w_in",), (d, f), d), (pre + ("w_out",), (f, d), f)]


def layout(m: dict) -> list:
    """``[(path, shape, fan_in)]`` in draw order, as :func:`perfbench.weights.layout`
    gives them (``fan_in`` 0: a zero norm gain); the router biases last."""
    d, V = m["d_model"], m["vocab_size"]
    E, held, fe = m["num_experts"], m["num_experts_held"], m["d_ff_expert"]
    n_dense = m["dense_prefix_layers"]
    out = [(("emb",), (V, d), 1)]
    for i in range(n_dense):
        pre = ("dense_layers", i)
        out += [(pre + ("ln1",), (d,), 0), (pre + ("ln2",), (d,), 0)] + _mla(m, pre)
        out += _gated(pre + ("mlp",), d, m["d_ff"])
    for i in range(m["num_layers"] - n_dense):
        pre = ("moe_layers", i)
        out += [(pre + ("ln1",), (d,), 0), (pre + ("ln2",), (d,), 0)] + _mla(m, pre)
        ex = pre + ("moe", "experts")
        out += [(pre + ("moe", "router"), (d, E), d), (ex + ("w_gate",), (held, d, fe), d),
                (ex + ("w_in",), (held, d, fe), d), (ex + ("w_out",), (held, fe, d), fe)]
        out += _gated(pre + ("moe", "shared"), d, fe * m["num_shared_experts"])
    out += [(("ln_f",), (d,), 0), (("lm_head",), (d, V), d)]
    out += [((BIAS, i), (E,), d) for i in range(m["num_layers"] - n_dense)]
    return out


def split(lay: list, leaves: list) -> tuple:
    """``(params, biases)``: the tree of the parameter leaves
    (:func:`perfbench.weights.tree`) and the router biases in layer order,
    float32 copies."""
    keep = [(e, x) for e, x in zip(lay, leaves) if e[0][0] != BIAS]
    params = W.tree([e for e, _ in keep], [x for _, x in keep])
    biases = [x.float() for e, x in zip(lay, leaves) if e[0][0] == BIAS]
    return params, biases


def param_layout(lay: list) -> list:
    """The entries of ``lay`` that are parameters (not the router biases)."""
    return [e for e in lay if e[0][0] != BIAS]


def flat_and_split(m: dict, seed: int, device, dtype: torch.dtype) -> tuple:
    """``(lay, flat, params, biases)`` from the seed (:func:`perfbench.weights.make_flat`)."""
    lay = layout(m)
    flat = W.make_flat(lay, seed, device, dtype)
    params, biases = split(lay, W.views(lay, flat))
    return lay, flat, params, biases
