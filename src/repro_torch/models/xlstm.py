"""xLSTM LM (arXiv:2405.04517): mLSTM blocks with one sLSTM block every
``cfg.slstm_every`` layers (7:1 for xlstm-1.3b), after the JAX package's
``models/xlstm.py`` (its simplifications: qk head dim = inner/(2H), gates
projected from the pre-conv up-projection, no post-FFN on the sLSTM blocks).

Parameters are a dict ``{"emb", "mlstm", "slstm", "ln_f", "lm_head"}``: the
reference's ``groups`` stack becomes two top-level lists, ``"mlstm"`` of
``n_groups * (period - 1)`` blocks (reference ``groups/mlstm[g, j]`` is
block ``g * (period - 1) + j``) and ``"slstm"`` of ``n_groups`` blocks, so
that Adafactor's ``stacks`` (:func:`repro_torch.models.layer_stacks`) hand
it the reference's stacked axes. Under ``cfg.remat == "full"`` or
``"dots"`` each group is checkpointed, as the reference checkpoints its
scan body.

The recurrent state (the decode "cache") is
``{"mlstm": (conv, (S, n, m)), "slstm": (c, n, m, h)}``: the mLSTM leaves
carry one leading axis of ``n_groups * (period - 1)`` layers (conv ``(.., B,
K-1, inner)`` in the compute dtype; ``S (.., B, H, DK, DV)``, ``n (.., B, H,
DK)``, ``m (.., B, H)`` float32), the sLSTM leaves ``(n_groups, B, H, D)``
float32. Its size does not depend on the sequence length. A decode step
returns a new state and leaves the given one as it was, as the reference
does; it holds nothing that grows, so there is nothing to write in place.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.torch_dp import resolve_device
from ..launch.sharding import linear, shard, whole_groups
from .dense import _embed, _logits, _maybe_remat, cross_entropy, dense_init
from .layers import rms_norm
from .ssm import causal_conv1d, causal_conv1d_step, mlstm_chunked, mlstm_step, slstm_scan, slstm_step

__all__ = [
    "init_xlstm",
    "init_xlstm_cache",
    "xlstm_decode_step",
    "xlstm_forward",
    "xlstm_loss",
]


def _dims(cfg: ModelConfig):
    inner = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    DV = inner // H
    DK = max(DV // 2, 1)
    return inner, H, DK, DV


def _layout(cfg: ModelConfig):
    """(n_groups, mLSTM blocks per group)."""
    return cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_mlstm_block(cfg: ModelConfig, gen: torch.Generator):
    d = cfg.d_model
    inner, H, DK, DV = _dims(cfg)
    pd, dev = cfg.pdtype(), gen.device
    return {
        "ln": torch.zeros((d,), dtype=pd, device=dev),
        "w_up": dense_init(gen, (d, 2 * inner), dtype=pd),
        "conv_w": dense_init(gen, (cfg.ssm_conv, inner), fan_in=cfg.ssm_conv, dtype=pd),
        # block-diagonal (head-wise) projections, as in the reference impl
        "wq_m": dense_init(gen, (H, DV, DK), fan_in=DV, dtype=pd),
        "wk_m": dense_init(gen, (H, DV, DK), fan_in=DV, dtype=pd),
        "wv_m": dense_init(gen, (H, DV, DV), fan_in=DV, dtype=pd),
        "wi_gate": dense_init(gen, (inner, H), dtype=pd),
        "wf_gate": dense_init(gen, (inner, H), dtype=pd),
        "f_bias": torch.full((H,), 3.0, dtype=pd, device=dev),  # open forget gates at init
        "gn": torch.zeros((H, DV), dtype=pd, device=dev),
        "out_proj": dense_init(gen, (inner, d), fan_in=inner, dtype=pd),
    }


def _init_slstm_block(cfg: ModelConfig, gen: torch.Generator):
    d = cfg.d_model
    H = cfg.num_heads
    D = d // H
    pd, dev = cfg.pdtype(), gen.device
    p = {
        "ln": torch.zeros((d,), dtype=pd, device=dev),
        "w_zifo": dense_init(gen, (d, 4, H * D), fan_in=d, dtype=pd),
    }
    for name in ("rz", "ri", "rf", "ro"):
        p[name] = dense_init(gen, (H, D, D), fan_in=D, dtype=pd, scale=0.3)
    p["f_bias"] = torch.full((H * D,), 3.0, dtype=pd, device=dev)
    p["gn"] = torch.zeros((H, D), dtype=pd, device=dev)
    p["out_proj"] = dense_init(gen, (d, d), dtype=pd)
    return p


def init_xlstm(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters on the generator's device, drawn in a fixed order
    (embedding, then group by group its mLSTM blocks and its sLSTM block,
    then the head)."""
    pd = cfg.pdtype()
    G, Pm = _layout(cfg)
    emb = dense_init(gen, (cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model, dtype=pd)
    mlstm, slstm = [], []
    for _ in range(G):
        mlstm += [_init_mlstm_block(cfg, gen) for _ in range(Pm)]
        slstm.append(_init_slstm_block(cfg, gen))
    return {
        "emb": emb,
        "mlstm": mlstm,
        "slstm": slstm,
        "ln_f": torch.zeros((cfg.d_model,), dtype=pd, device=gen.device),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=pd),
    }


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------


def _mlstm_block(cfg, p, h, state=None, step=False):
    """state: (conv_state (B,K-1,inner), (S,n,m)) or None (zeros). Returns
    (h, new_state)."""
    inner, H, DK, DV = _dims(cfg)
    x = rms_norm(h, p["ln"])
    up = linear(x, p["w_up"])
    xm, z = up[..., :inner], up[..., inner:]
    xm = shard(xm, "batch", None, "tensor")
    conv_state = state[0] if state is not None else None
    if step:
        xc, conv_state = causal_conv1d_step(xm, p["conv_w"], conv_state)
    else:
        xc, conv_state = causal_conv1d(xm, p["conv_w"], conv_state)
    xc = F.silu(xc)
    B, S = x.shape[0], x.shape[1]
    # per-head input stream (DV == inner/H); on a mesh the heads stay whole
    xc_h = whole_groups(xc, -1, H).reshape(B, S, H, DV)
    xm_h = whole_groups(xm, -1, H).reshape(B, S, H, DV)
    q = torch.einsum("bshp,hpk->bshk", xc_h, p["wq_m"])
    k = torch.einsum("bshp,hpk->bshk", xc_h, p["wk_m"])
    v = torch.einsum("bshp,hpk->bshk", xm_h, p["wv_m"])
    i_pre = linear(xm, p["wi_gate"])
    f_pre = linear(xm, p["wf_gate"]) + p["f_bias"].float()

    cell_state = state[1] if state is not None else None
    if step:
        y, cell_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0], cell_state)
        y = y[:, None]
    else:
        y, cell_state = mlstm_chunked(q, k, v, i_pre, f_pre, chunk=min(cfg.chunk_size, S), state=cell_state)
    # per-head groupnorm + gate
    y = rms_norm(y, p["gn"])  # (B,S,H,DV) normalized over DV
    # whole_groups pins the gradient to whole heads (it cannot split them)
    y = whole_groups(y.reshape(B, S, inner), -1, H) * F.silu(z)
    return h + linear(y, p["out_proj"]), (conv_state, cell_state)


def _slstm_block(cfg, p, h, state=None, step=False):
    d = cfg.d_model
    H = cfg.num_heads
    D = d // H
    x = rms_norm(h, p["ln"])
    B, S = x.shape[0], x.shape[1]
    # the gates lead the product's columns: whole before they are unbound;
    # the flattened weight's gradient comes back in the weight's placements
    # before it is unflattened (4 gates do not divide a model axis of 16)
    w = whole_groups(p["w_zifo"].reshape(d, -1), 1, 4)
    zifo = whole_groups(linear(x, w), -1).reshape(B, S, 4, H, D)
    z, i_pre, f_pre, o_pre = zifo.unbind(2)
    f_pre = f_pre + p["f_bias"].to(zifo.dtype).reshape(H, D)
    r = {k: p[k] for k in ("rz", "ri", "rf", "ro")}
    if step:
        c, n, m, h_prev = state

        def rec(w):
            return torch.einsum("bhd,hde->bhe", h_prev, w.float())

        y, (c, n, m) = slstm_step(
            z[:, 0] + rec(r["rz"]), i_pre[:, 0] + rec(r["ri"]),
            f_pre[:, 0] + rec(r["rf"]), o_pre[:, 0] + rec(r["ro"]), (c, n, m),
        )
        new_state = (c, n, m, y.float())
        y = y[:, None]
    else:
        y, new_state = slstm_scan(z, i_pre, f_pre, o_pre, r, state)
    y = rms_norm(y.to(h.dtype), p["gn"])  # the recurrent path is float32
    return h + linear(whole_groups(y.reshape(B, S, d), -1, H), p["out_proj"]), new_state


def _group_apply(cfg, mlstm, slstm, h, m_states, s_state, step=False):
    """One group: ``len(mlstm)`` mLSTM blocks, then the sLSTM block.
    ``m_states`` is a list of per-block states (or ``None`` entries: zero
    state). Returns (h, new mLSTM states, new sLSTM state)."""
    new_m = []
    for p, st in zip(mlstm, m_states):
        h, st = _mlstm_block(cfg, p, h, st, step=step)
        new_m.append(st)
    h, new_s = _slstm_block(cfg, slstm, h, s_state, step=step)
    return shard(h, "batch", "act_seq", None), new_m, new_s


def _group_states(cfg, state, g):
    """Group ``g``'s (mLSTM states, sLSTM state) from a stacked state, or
    zero states (``None``) without one."""
    Pm = _layout(cfg)[1]
    if state is None:
        return [None] * Pm, None
    conv, (S, n, m) = state["mlstm"]
    rows = range(g * Pm, (g + 1) * Pm)
    return [(conv[i], (S[i], n[i], m[i])) for i in rows], tuple(x[g] for x in state["slstm"])


def _stack_states(m_states, s_states):
    """Per-block states back into the stacked layout of :func:`init_xlstm_cache`."""
    conv = torch.stack([st[0] for st in m_states])
    cell = tuple(torch.stack([st[1][i] for st in m_states]) for i in range(3))
    return {"mlstm": (conv, cell), "slstm": tuple(torch.stack(xs) for xs in zip(*s_states))}


def init_xlstm_cache(cfg: ModelConfig, batch: int, max_len: int = 0, device="cuda"):
    """The zero recurrent state for ``batch`` sequences (``max_len`` is
    unused: the state does not grow), on ``device``."""
    inner, H, DK, DV = _dims(cfg)
    G, Pm = _layout(cfg)
    D = cfg.d_model // H
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    Lm = G * Pm
    mlstm = (
        torch.zeros((Lm, batch, cfg.ssm_conv - 1, inner), dtype=cfg.cdtype(), device=dev),
        (torch.zeros((Lm, batch, H, DK, DV), **f32), torch.zeros((Lm, batch, H, DK), **f32),
         torch.full((Lm, batch, H), -1e30, **f32)),
    )
    slstm = (torch.zeros((G, batch, H, D), **f32), torch.zeros((G, batch, H, D), **f32),
             torch.full((G, batch, H, D), -1e30, **f32), torch.zeros((G, batch, H, D), **f32))
    return {"mlstm": mlstm, "slstm": slstm}


def _run(cfg, params, h, state, step, collect):
    """The groups in order from ``state`` (zeros if ``None``), each
    checkpointed under ``remat="full"`` or ``"dots"`` when grad mode is on
    (:func:`repro_torch.models.dense._maybe_remat`). Returns (h,
    the stacked new state if ``collect``, else ``None``)."""
    G, Pm = _layout(cfg)
    body = _maybe_remat(cfg, functools.partial(_group_apply, cfg, step=step))
    m_all, s_all = [], []
    for g in range(G):
        m_states, s_state = _group_states(cfg, state, g)
        h, new_m, new_s = body(params["mlstm"][g * Pm:(g + 1) * Pm], params["slstm"][g], h, m_states, s_state)
        if collect:
            m_all += new_m
            s_all.append(new_s)
    return h, (_stack_states(m_all, s_all) if collect else None)


def xlstm_forward(params, cfg: ModelConfig, tokens, *, state=None, collect_state=False):
    """tokens ``(B, S)`` -> ``(logits, state)``: float32 logits ``(B, S,
    V)`` and, with ``collect_state``, the recurrent state after the last
    token (the layout of :func:`init_xlstm_cache`), else ``None``. ``state``
    is the state before the first token (zeros if ``None``)."""
    h = _embed(cfg, params, tokens)
    h, new_state = _run(cfg, params, h, state, False, collect_state)
    return _logits(cfg, params, h), new_state


def xlstm_loss(params, cfg: ModelConfig, batch):
    tokens = batch["tokens"]
    logits, _ = xlstm_forward(params, cfg, tokens[:, :-1])
    return cross_entropy(logits, tokens[:, 1:])


def xlstm_decode_step(params, cfg: ModelConfig, state, tokens, pos=None):
    """tokens ``(B, 1)`` -> ``(logits (B, 1, V), new state)``; ``pos`` is
    unused (the state carries the position)."""
    h = _embed(cfg, params, tokens)
    h, new_state = _run(cfg, params, h, state, True, True)
    return _logits(cfg, params, h), new_state
