"""State-space / recurrent cells: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM),
after the JAX package's ``models/ssm.py``, one function for each of its
functions, with the same arguments and shapes.

All cells come in two forms with identical semantics:
  * a chunked/parallel form for training and prefill (a loop over chunks,
    quadratic within a chunk);
  * a single-step recurrent form for decode (O(1) state update).

Shapes:  x (B, L, H, P) heads/headdim;  ssm state (B, H, P, N);
         mLSTM state (B, H, DK, DV) + normalizer (B, H, DK) + stabilizer (B, H).

Differences from the reference, none of which changes a value beyond
float32 rounding:

* The reference's multi-operand einsums are written out as products of two
  operands in a fixed order (``torch.einsum`` would pick a contraction path
  with opt_einsum where it is installed and contract left to right where it
  is not, and a bad path builds ``(B, Q, S, H, P)`` intermediates). So
  ``ssd_chunked``'s intra-chunk term is ``CB = C Bᵀ (b, q, s)``, then
  ``W = CB ∘ L ∘ dt (b, h, q, s)``, then ``W x``; its inter-chunk output and
  its chunk state are formed the same way.
* The per-chunk ``jax.checkpoint`` is ``torch.utils.checkpoint`` (not
  reentrant), applied only when grad mode is on, as
  :func:`repro_torch.models.dense._maybe_remat` does; under ``remat="full"``
  or ``"dots"`` it sits inside the group's checkpoint (its products are
  batched over heads, so ``"dots"`` saves none of them, as the reference's
  ``nothing_saveable`` chunk inside its group saves none).
* ``torch.einsum`` refuses mixed dtypes where ``jnp.einsum`` promotes, so
  the sLSTM's bfloat16 recurrent weights are widened to float32 before they
  meet the float32 ``h``: ``z_t`` and ``h`` come out float32, as in the
  reference.

Under a mesh (DTensor arguments) each cell runs once on every rank's local
shards (:func:`repro_torch.launch.sharding.local_shards`): the cells are
independent per batch row and per head, the convs per channel, so batch
goes to the batch axes and heads (channels) to the tensor axes, where they
divide them. DTensor's host dispatch is then paid once per cell call, not
once per chunk or per sLSTM time step.

In a dry run (fake tensors under an active
:class:`repro_torch.launch.hlo_analysis.CostCounter`) the sLSTM scan and
the mLSTM chunk loop are counted by their trip counts, as the reference's
HLO walker expands a ``while`` body: their first and last trips run, and
one trip stands for all the others (:func:`_slstm_by_trips`,
:func:`_mlstm_by_trips`). The count equals the full loop's. On real tensors,
or with no counter, every trip runs. The SSD chunk loop always runs whole.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..launch.hlo_analysis import run_trips, trip_counters
from ..launch.sharding import local_shards

__all__ = [
    "causal_conv1d",
    "causal_conv1d_step",
    "mlstm_chunked",
    "mlstm_step",
    "slstm_scan",
    "slstm_step",
    "ssd_chunked",
    "ssd_step",
]


# logical specs of the cells' arguments (batch, length, heads or channels, ...)
_BLC = ("batch", None, "tensor")  # also (B, L, H) gates, (B, K-1, C) conv states
_BLHD = ("batch", None, "tensor", None)
_BH = ("batch", "tensor")
_BHD = ("batch", "tensor", None)
_BHDD = ("batch", "tensor", None, None)
_BN = ("batch", None)
_BLN = ("batch", None, None)
_H = ("tensor",)
_HDD = ("tensor", None, None)


def _chunk_remat(fn):
    """``fn`` under ``torch.utils.checkpoint`` when grad mode is on (the
    reference's ``jax.checkpoint`` with ``nothing_saveable`` on each chunk):
    the backward pass recomputes the chunk's quadratic decay matrix instead
    of keeping one per chunk."""
    if torch.is_grad_enabled():
        return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)
    return fn


def _flat(out):
    """A cell's ``(y, state_tuple)`` as one flat tuple (``local_shards``
    takes flat outputs)."""
    y, state = out
    return (y, *state)


def _n_chunks(L: int, chunk: int) -> int:
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"chunk {chunk} must divide the sequence length {L}")
    return nc


# ---------------------------------------------------------------------------
# depthwise causal conv (mamba2 front conv)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """x: (B, L, C); w: (K, C) depthwise. Returns (y, new_state) where
    state is the trailing K-1 inputs for streaming decode."""
    if isinstance(x, DTensor):
        return local_shards(causal_conv1d, (x, w, state), (_BLC, (None, "tensor"), _BLC), (_BLC, _BLC))
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, L+K-1, C)
    L = x.shape[1]
    y = sum(xp[:, i:i + L, :] * w[i] for i in range(K))
    new_state = xp[:, L:, :] if K > 1 else x.new_zeros((x.shape[0], 0, x.shape[2]))
    return y, new_state


def causal_conv1d_step(x_t: torch.Tensor, w: torch.Tensor, state: torch.Tensor):
    """x_t: (B, 1, C); state: (B, K-1, C)."""
    if isinstance(x_t, DTensor):
        return local_shards(causal_conv1d_step, (x_t, w, state), (_BLC, (None, "tensor"), _BLC), (_BLC, _BLC))
    window = torch.cat([state.to(x_t.dtype), x_t], dim=1)  # (B, K, C)
    y = (window * w).sum(dim=1)[:, None, :]
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q). Returns (..., Q, Q) with out[t, s] = sum_{s < r <= t} a[r]
    for t >= s, -inf below the diagonal band."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def _ssd_chunk(s, xq, dq, Bq, Cq, A):
    """One chunk: the quadratic intra-chunk term plus the carried state's
    contribution. xq (B,Q,H,P) in x's dtype; dq (B,Q,H), Bq, Cq (B,Q,N), s
    (B,H,P,N) and A (H,) float32. Returns (new state, y (B,Q,H,P) in x's
    dtype)."""
    xh = xq.float().transpose(1, 2)  # (B,H,Q,P)
    dh = dq.transpose(1, 2)  # (B,H,Q)
    a = dh * A[:, None]  # (B,H,Q)
    Lmat = torch.exp(_segsum(a))  # (B,H,Q,Q)
    # y_diag = einsum("bqn,bsn,bhqs,bsh,bshp->bqhp", C, B, L, dt, x)
    CB = Cq @ Bq.transpose(1, 2)  # (B,Q,S)
    W = CB[:, None] * Lmat * dh[:, :, None, :]  # (B,H,Q,S)
    y_diag = W @ xh  # (B,H,Q,P)
    a_cum = torch.cumsum(a, dim=-1)  # (B,H,Q)
    # y_off = einsum("bqn,bhq,bhpn->bqhp", C, exp(a_cum), s)
    y_off = (Cq[:, None] @ s.transpose(-1, -2)) * torch.exp(a_cum)[..., None]  # (B,H,Q,P)
    # S_c = einsum("bsn,bhs,bsh,bshp->bhpn", B, decay_to_end, dt, x)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)  # (B,H,Q)
    S_c = (xh * (decay_to_end * dh)[..., None]).transpose(-1, -2) @ Bq[:, None]  # (B,H,P,N)
    s_new = s * torch.exp(a_cum[..., -1])[..., None, None] + S_c
    return s_new, (y_diag + y_off).transpose(1, 2).to(xq.dtype)


def ssd_chunked(x, dt, A, B, C, chunk: int, state=None):
    """Structured state-space duality (Mamba2), chunked.

    Args:
      x: (B, L, H, P) values.
      dt: (B, L, H) positive step sizes (post-softplus).
      A: (H,) negative decay rates.
      B, C: (B, L, N) shared across heads (G=1 groups).
      chunk: chunk length (must divide L).
      state: optional initial state (B, H, P, N).

    Returns: y (B, L, H, P), final_state (B, H, P, N) float32.

    The chunks run one after another, so the (B, H, Q, Q) decay matrix
    exists for one chunk at a time; each chunk is checkpointed under grad
    mode. Each output entry of the intra-chunk term is a sum of at most
    ``chunk`` float32 products, formed in another order than XLA's, so the
    two differ by float32 rounding that grows with the chunk length.
    """
    if isinstance(x, DTensor):
        return local_shards(lambda *a: ssd_chunked(*a[:5], chunk, a[5]), (x, dt, A, B, C, state),
                            (_BLHD, _BLC, _H, _BLN, _BLN, _BHDD), (_BLHD, _BHDD))
    Bsz, L, H, P = x.shape
    N = B.shape[-1]
    nc = _n_chunks(L, chunk)
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = B.reshape(Bsz, nc, chunk, N).float()
    Cc = C.reshape(Bsz, nc, chunk, N).float()
    s = x.new_zeros((Bsz, H, P, N), dtype=torch.float32) if state is None else state.float()
    A32 = A.float()
    body = _chunk_remat(_ssd_chunk)
    ys = []
    for c in range(nc):
        s, y = body(s, xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], A32)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def ssd_step(x_t, dt_t, A, B_t, C_t, state):
    """One decode step. x_t (B, H, P); dt_t (B, H); B_t, C_t (B, N);
    state (B, H, P, N). Returns (y (B, H, P), new_state)."""
    if isinstance(x_t, DTensor):
        return local_shards(ssd_step, (x_t, dt_t, A, B_t, C_t, state), (_BHD, _BH, _H, _BN, _BN, _BHDD),
                            (_BHD, _BHDD))
    dt32 = dt_t.float()
    dec = torch.exp(dt32 * A.float()[None, :])  # (B, H)
    upd = (dt32[..., None] * x_t.float())[..., None] * B_t.float()[:, None, None, :]  # (B,H,P,N)
    new_state = state.float() * dec[..., None, None] + upd
    y = (new_state @ C_t.float()[:, None, :, None])[..., 0]  # (B,H,P)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory) — stabilized chunkwise form
# ---------------------------------------------------------------------------


def _mlstm_chunk(S, n, m, qq, kk, vv, Fq, gq, gmax, flast):
    """One chunk of :func:`mlstm_chunked`: qq, kk (B,Q,H,DK), vv (B,Q,H,DV);
    Fq, gq, gmax (B,Q,H); flast (B,H); carry S (B,H,DK,DV), n (B,H,DK), m
    (B,H). Returns (S, n, m, h (B,Q,H,DV))."""
    Q = qq.shape[1]
    m_intra = Fq + gmax  # (B, Q, H)
    m_inter = Fq + m[:, None, :]
    m_t = torch.maximum(m_intra, m_inter)

    # inter-chunk: h_inter = (q . S) * exp(F + m_prev - m_t)
    w_inter = torch.exp(m_inter - m_t)  # (B,Q,H)
    qh = qq.transpose(1, 2)  # (B,H,Q,DK)
    h_inter = (qh @ S).transpose(1, 2) * w_inter[..., None]  # (B,Q,H,DV)
    l_inter = (qq * n[:, None]).sum(dim=-1) * w_inter  # (B,Q,H)

    # intra-chunk: D[t,s] = exp(F_t - F_s + logi_s - m_t) for s <= t
    Dlog = Fq[:, :, None, :] + gq[:, None, :, :] - m_t[:, :, None, :]  # (B,Q,S,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=qq.device))
    D = torch.exp(Dlog.masked_fill(~tri[None, :, :, None], float("-inf")))
    qk = (qh @ kk.permute(0, 2, 3, 1)).permute(0, 2, 3, 1)  # (B,Q,S,H)
    W = qk * D
    h_intra = (W.permute(0, 3, 1, 2) @ vv.transpose(1, 2)).transpose(1, 2)  # (B,Q,H,DV)
    l_intra = W.sum(dim=2)  # (B,Q,H)

    denom = torch.maximum(torch.abs(l_inter + l_intra), torch.exp(-m_t))
    h = (h_inter + h_intra) / denom[..., None]

    # carry update
    m_new = torch.maximum(flast + m, flast + gmax[:, -1, :])  # (B, H)
    w_old = torch.exp(flast + m - m_new)
    w_in = torch.exp(flast[:, None, :] + gq - m_new[:, None, :])  # (B,Q,H)
    kw = kk * w_in[..., None]  # (B,Q,H,DK)
    S_new = S * w_old[..., None, None] + kw.permute(0, 2, 3, 1) @ vv.transpose(1, 2)
    n_new = n * w_old[..., None] + kw.sum(dim=1)
    return S_new, n_new, m_new, h


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """q, k: (B, L, H, DK); v: (B, L, H, DV); i_pre, f_pre: (B, L, H).

    state: optional (S (B,H,DK,DV), n (B,H,DK), m (B,H)).
    Returns: h (B, L, H, DV) in v's dtype, (S, n, m) final, float32.
    On a dry run's fake tensors under a cost counter the chunk loop is
    counted by its trip count (:func:`_mlstm_by_trips`).
    """
    if isinstance(q, DTensor):
        h, *new = local_shards(lambda *a: _flat(mlstm_chunked(*a[:5], chunk, None if a[5] is None else a[5:])),
                               (q, k, v, i_pre, f_pre, *(state or (None,))),
                               (_BLHD, _BLHD, _BLHD, _BLC, _BLC, _BHDD, _BHD, _BH), (_BLHD, _BHDD, _BHD, _BH))
        return h, tuple(new)
    Bsz, L, H, DK = q.shape
    DV = v.shape[-1]
    nc = _n_chunks(L, chunk)
    scale = DK ** -0.5

    qc = q.reshape(Bsz, nc, chunk, H, DK).float() * scale
    kc = k.reshape(Bsz, nc, chunk, H, DK).float()
    vc = v.reshape(Bsz, nc, chunk, H, DV).float()
    logf = F.logsigmoid(f_pre.reshape(Bsz, nc, chunk, H).float())
    logi = i_pre.reshape(Bsz, nc, chunk, H).float()

    Fc = torch.cumsum(logf, dim=2)  # (B, nc, Q, H): decay chunk-start..t (incl t)
    F_last = Fc[:, :, -1, :]  # (B, nc, H)
    g = logi - Fc  # (B, nc, Q, H)
    g_runmax = torch.cummax(g, dim=2).values

    if state is None:
        S = q.new_zeros((Bsz, H, DK, DV), dtype=torch.float32)
        n = q.new_zeros((Bsz, H, DK), dtype=torch.float32)
        m = q.new_full((Bsz, H), -1e30, dtype=torch.float32)
    else:
        S, n, m = (s.float() for s in state)

    body = _chunk_remat(_mlstm_chunk)
    parts = (qc, kc, vc, Fc, g, g_runmax, F_last)
    counters = trip_counters(*parts, S, n, m)
    if counters and nc > 3:
        return _mlstm_by_trips(counters, body, parts, S, n, m, v.dtype)
    hs = []
    for c in range(nc):
        S, n, m, h = body(S, n, m, qc[:, c], kc[:, c], vc[:, c], Fc[:, c], g[:, c], g_runmax[:, c], F_last[:, c])
        hs.append(h)
    return torch.cat(hs, dim=1).to(v.dtype), (S, n, m)


def _mlstm_by_trips(counters, body, parts, S, n, m, dtype):
    """:func:`mlstm_chunked`'s chunk loop on a dry run's fake tensors under a
    cost counter, as :func:`_slstm_by_trips` runs the sLSTM's time loop:
    the first and last chunks as the loop runs them, the ``nc - 2`` between
    once, as chunk 1, counted ``nc - 2`` times (:func:`run_trips`). The
    loop's chunk outputs take one gradient each (from the ``cat``), so the
    repeats of chunk 1's are detached: stacked as one tensor, the copies'
    gradients would be summed, which the loop does not do."""
    nc = parts[0].shape[1]

    def chunk(c, *a):  # a: the chunked inputs, then the carried (S, n, m)
        return body(*a[len(parts):], *(x[:, c] for x in a[:len(parts)]))

    S, n, m, h0 = chunk(0, *parts, S, n, m)
    S, n, m, h1 = run_trips(counters, nc - 2, functools.partial(chunk, 1), parts, (S, n, m))
    S, n, m, h = chunk(nc - 1, *parts, S, n, m)
    hs = [h0, h1] + [h1.detach()] * (nc - 3) + [h]
    return torch.cat(hs, dim=1).to(dtype), (S, n, m)


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """One decode step. q_t,k_t (B,H,DK); v_t (B,H,DV); i_t,f_t (B,H);
    state (S, n, m). Returns (h (B,H,DV), new_state)."""
    if isinstance(q_t, DTensor):
        h, *new = local_shards(lambda *a: _flat(mlstm_step(*a[:5], a[5:])), (q_t, k_t, v_t, i_t, f_t, *state),
                               (_BHD, _BHD, _BHD, _BH, _BH, _BHDD, _BHD, _BH), (_BHD, _BHDD, _BHD, _BH))
        return h, tuple(new)
    S, n, m = (s.float() for s in state)
    DK = q_t.shape[-1]
    logf = F.logsigmoid(f_t.float())
    logi = i_t.float()
    m_new = torch.maximum(logf + m, logi)
    w_old = torch.exp(logf + m - m_new)
    w_in = torch.exp(logi - m_new)
    kk = k_t.float()
    vv = v_t.float()
    S_new = S * w_old[..., None, None] + w_in[..., None, None] * kk[..., :, None] * vv[..., None, :]
    n_new = n * w_old[..., None] + w_in[..., None] * kk
    qq = q_t.float() * DK ** -0.5
    num = (qq[..., None, :] @ S_new)[..., 0, :]  # (B,H,DV)
    den = torch.maximum(torch.abs((qq * n_new).sum(dim=-1)), torch.exp(-m_new))
    h = num / den[..., None]
    return h.to(v_t.dtype), (S_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential by construction)
# ---------------------------------------------------------------------------


def slstm_step(z_t, i_t, f_t, o_t, state):
    """z,i,f,o: (B, H, D) pre-activations; state (c, n, m) each (B, H, D)."""
    if isinstance(z_t, DTensor):
        h, *new = local_shards(lambda *a: _flat(slstm_step(*a[:4], a[4:])), (z_t, i_t, f_t, o_t, *state),
                               (_BHD,) * 7, (_BHD,) * 4)
        return h, tuple(new)
    c, n, m = state
    logf = F.logsigmoid(f_t.float())
    logi = i_t.float()
    m_new = torch.maximum(logf + m, logi)
    c_new = torch.exp(logf + m - m_new) * c + torch.exp(logi - m_new) * torch.tanh(z_t.float())
    n_new = torch.exp(logf + m - m_new) * n + torch.exp(logi - m_new)
    h = torch.sigmoid(o_t.float()) * c_new / n_new.clamp_min(1e-6)
    return h.to(z_t.dtype), (c_new, n_new, m_new)


def slstm_scan(z, i_pre, f_pre, o_pre, r_weights, state=None, unroll: int = 16):
    """Sequential scan over time with head-wise recurrent connections.

    z, i_pre, f_pre, o_pre: (B, L, H, D). r_weights: dict of (H, D, D)
    recurrent matrices for each gate (``rz``, ``ri``, ``rf``, ``ro``).
    state: optional (c, n, m, h_prev). Returns (h (B, L, H, D), final_state).

    A Python loop over the L time steps: at each, one batched product of
    ``h_prev`` with the four recurrent matrices side by side (each gate's
    entries are the reference's ``einsum("bhd,bhde->bhe")``), then
    :func:`slstm_step`. The weights are widened to float32 once, so ``h``
    and the pre-activations it meets come out float32. ``unroll`` is kept
    for the reference's signature and does nothing here; there it is the
    scan's unroll factor, and the batch-broadcast of the recurrent weights
    is a GSPMD device for sharded gradients; both are the identity on one
    device. On a dry run's fake tensors under a cost counter the loop is
    counted by its trip count (:func:`_slstm_by_trips`).
    """
    gates = ("rz", "ri", "rf", "ro")
    if isinstance(z, DTensor):
        h, *new = local_shards(
            lambda *a: _flat(slstm_scan(*a[:4], dict(zip(gates, a[4:8])), None if a[8] is None else a[8:])),
            (z, i_pre, f_pre, o_pre, *(r_weights[g] for g in gates), *(state or (None,))),
            (_BLHD,) * 4 + (_HDD,) * 4 + (_BHD,) * 4, (_BLHD,) + (_BHD,) * 4)
        return h, tuple(new)
    Bsz, L, H, D = z.shape
    if state is None:
        zeros = z.new_zeros((Bsz, H, D), dtype=torch.float32)
        state = (zeros, zeros, z.new_full((Bsz, H, D), -1e30, dtype=torch.float32), zeros)
    c, n, m, h_prev = state
    w = torch.cat([r_weights[k].float() for k in gates], dim=-1)  # (H, D, 4D)
    pre = torch.stack([z, i_pre, f_pre, o_pre], dim=2)  # (B, L, 4, H, D)
    counters = trip_counters(pre, w, c, n, m, h_prev)
    if counters and L > 3:
        return _slstm_by_trips(counters, pre, w, c, n, m, h_prev)
    hs = []
    for t in range(L):
        h, c, n, m = _slstm_time_step(pre, w, t, c, n, m, h_prev)
        h_prev = h.float()
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h_prev)


def _slstm_time_step(pre, w, t, c, n, m, h_prev):
    """Time step ``t`` of :func:`slstm_scan`: ``(h, c, n, m)``."""
    D = pre.shape[-1]
    rec = (h_prev.transpose(0, 1) @ w).unflatten(-1, (4, D)).permute(1, 2, 0, 3)  # (B, 4, H, D)
    z_t, i_t, f_t, o_t = (pre[:, t] + rec).unbind(1)
    h, (c, n, m) = slstm_step(z_t, i_t, f_t, o_t, (c, n, m))
    return h, c, n, m


def _slstm_by_trips(counters, pre, w, c, n, m, h_prev):
    """:func:`slstm_scan` on a dry run's fake tensors under a cost counter
    (the reference's HLO walker expands the scan's ``while`` body by its
    trip count): the first and the last time steps run as the loop runs
    them (the first reads a state that may need no gradient, the last hands
    none on), and the ``L - 2`` between run once, as step 1, counted ``L -
    2`` times forward and backward (:func:`run_trips`). The output and the
    final state have the loop's shapes; ``h`` is stacked from ``L`` entries
    as the loop stacks it. Each of the loop's ``h`` takes two gradients
    (the stack's and the next step's), so the engine's sum of the stack's
    ``L - 2`` gradients of step 1's ``h`` and the last step's is the loop's
    one add a step."""
    L = pre.shape[1]
    h0, c, n, m = _slstm_time_step(pre, w, 0, c, n, m, h_prev)
    h1, c, n, m = run_trips(counters, L - 2, lambda pre, w, *s: _slstm_time_step(pre, w, 1, *s), (pre, w),
                            (c, n, m, h0.float()))
    h, c, n, m = _slstm_time_step(pre, w, L - 1, c, n, m, h1.float())
    return torch.stack([h0] + [h1] * (L - 2) + [h], dim=1), (c, n, m, h.float())
