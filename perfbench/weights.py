"""The benchmark's inputs: the parameters and the token batches of a cell,
made on the card from ``--seed``.

The parameters are one flat buffer in the configuration's parameter dtype,
filled by a few large draws of a ``torch.Generator`` on the device, and the
leaves are views of it. The same seed on the same device gives the same
bits, so the reference (:mod:`perfbench.reference`) makes its own copy of
the starting point from the seed after the program's state is freed, and
both sides start from the same values without either taking the other's
tensors.

The layout (:func:`layout`) names every leaf by its path in the parameter
tree of the program's dense and MoE decoders (``emb``, ``layers`` or
``moe_layers``, ``ln_f``, ``lm_head``), with its shape and its draw: a
normal truncated at two standard deviations times ``1 / sqrt(fan_in)`` for a
matrix, zeros for a norm gain (the norms scale by ``1 + gain``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["batch_pool", "layout", "leaf", "make_flat", "numel", "tree", "views"]

# elements drawn per call: 2**28 float32 values, 1 GiB of scratch
_CHUNK = 1 << 28
_MASK63 = (1 << 63) - 1


def _seed(seed: int, stream: int) -> int:
    """A generator seed for one of the run's streams (0: weights, 1:
    batches), distinct for every (seed, stream)."""
    return (int(seed) * 2 + stream) & _MASK63


def _attn(m, d):
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // H
    return [("wq", (d, H, hd), d), ("wk", (d, Hkv, hd), d), ("wv", (d, Hkv, hd), d), ("wo", (H, hd, d), H * hd)]


def layout(m: dict) -> list:
    """``[(path, shape, fan_in)]`` in draw order; ``fan_in`` 0 marks a
    zero-initialised norm gain. ``path`` is a tuple of dict keys and list
    indices."""
    d, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    out = [(("emb",), (V, d), d)]
    stack = "layers" if m["family"] == "dense" else "moe_layers"
    for i in range(L):
        pre = (stack, i)
        out += [(pre + ("ln1",), (d,), 0), (pre + ("ln2",), (d,), 0)]
        out += [(pre + ("attn", n), s, f) for n, s, f in _attn(m, d)]
        if m["family"] == "dense":
            ff = m["d_ff"]
            out += [(pre + ("mlp", "w_gate"), (d, ff), d), (pre + ("mlp", "w_in"), (d, ff), d),
                    (pre + ("mlp", "w_out"), (ff, d), ff)]
        elif m["family"] == "moe":
            E, fe = m["num_experts"], m["d_ff_expert"]
            out += [(pre + ("moe", "router"), (d, E), d),
                    (pre + ("moe", "experts", "w_gate"), (E, d, fe), d),
                    (pre + ("moe", "experts", "w_in"), (E, d, fe), d),
                    (pre + ("moe", "experts", "w_out"), (E, fe, d), fe)]
        else:
            raise ValueError(f"no parameter layout for family {m['family']!r}")
    out += [(("ln_f",), (d,), 0), (("lm_head",), (d, V), d)]
    return out


def numel(lay: list) -> int:
    """Parameters in ``lay``."""
    return sum(math.prod(s) for _, s, _ in lay)


def make_flat(lay: list, seed: int, device, dtype: torch.dtype) -> torch.Tensor:
    """The parameters of ``lay`` as one flat ``dtype`` tensor on ``device``:
    standard normals truncated at +-2 drawn in float32 in chunks of
    ``_CHUNK``, cast, then each matrix scaled by ``1 / sqrt(fan_in)`` and each
    gain zeroed in place."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 0))
    n = numel(lay)
    flat = torch.empty(n, dtype=dtype, device=device)
    scratch = torch.empty(min(n, _CHUNK), dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        part = scratch[: min(_CHUNK, n - start)]
        part.normal_(generator=gen).clamp_(-2.0, 2.0)
        flat[start:start + part.numel()].copy_(part)
    del scratch
    for (_, _, fan_in), x in zip(lay, views(lay, flat)):
        if fan_in:
            x.mul_(1.0 / math.sqrt(fan_in))
        else:
            x.zero_()
    return flat


def views(lay: list, flat: torch.Tensor) -> list:
    """The leaves of ``lay`` as views of ``flat``, in layout order."""
    out, off = [], 0
    for _, shape, _ in lay:
        k = math.prod(shape)
        out.append(flat[off:off + k].view(shape))
        off += k
    return out


def tree(lay: list, leaves: list):
    """The nested dicts and lists that the paths of ``lay`` describe, with
    ``leaves`` (layout order, so each list's indices come in order) at their
    places."""
    root: dict = {}
    for (path, _, _), x in zip(lay, leaves):
        node = root
        for key, nxt in zip(path[:-1], path[1:]):
            fresh = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                if key == len(node):
                    node.append(fresh)
                node = node[key]
            else:
                node = node.setdefault(key, fresh)
        node[path[-1]] = x
    return root


def leaf(t, path: tuple):
    """The leaf of tree ``t`` at ``path``."""
    for key in path:
        t = t[key]
    return t


def batch_pool(seed: int, rows: int, batch: int, seq_len: int, vocab: int, device) -> torch.Tensor:
    """``rows`` batches of ``batch`` rows of ``seq_len + 1`` token ids, uniform
    over the vocabulary, int64, ``(rows, batch, seq_len + 1)``: one draw of
    a generator on the device."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 1))
    return torch.randint(0, vocab, (rows, batch, seq_len + 1), generator=gen, device=device)
