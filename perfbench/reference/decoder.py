"""The plain reference of the benchmark's training cells: a decoder LM's
loss, its gradients and AdamW steps, in plain PyTorch.

It follows the published description of the two families the cells run,
as the configuration files state them (``perfbench/configs/*.json``, the
``model`` and ``train`` entries):

* token embedding; per layer a pre-norm block: RMSNorm scaled by
  ``1 + gain``, multi-head causal attention with rotary embeddings on split
  halves (base ``rope_base``) and a softmax scale of ``head_dim ** -0.5``,
  then a pre-norm feed-forward, added to the residual; a final RMSNorm and
  an untied output head; the mean next-token negative log-likelihood;
* the feed-forward of a dense model: the gated-SiLU MLP;
* the feed-forward of a MoE model: a float32 softmax router over
  ``num_experts``, the ``top_k`` largest probabilities (ties to the lower
  expert), renormalised to sum to one where ``norm_topk_prob``; each token
  runs only the experts it chose, each a gated-SiLU MLP, and their outputs
  are summed by its gates;
  the load-balance term ``E * sum_e f_e * P_e`` (``f_e`` the share of the
  (token, choice) pairs routed to ``e``, ``P_e`` its mean probability),
  averaged over the layers and added with weight ``router_aux_weight``;
* AdamW at the rounding points the configuration states: parameters and
  the first moment in the parameter dtype, the second moment in float32,
  the gradient in the parameter dtype as the optimizer gets it, the scalars
  rounded to the moment's dtype, the bias corrections float32 powers of the
  step, the update cast to the parameter dtype before it is added.

Every product, norm, softmax and sum runs in float32 with TF32 off
(``precision="float32"``). ``precision="fp8"`` is the benchmark's control:
the same computation with every product's operands rounded to float8 e4m3
(per-tensor scale) in the forward pass and its output's gradient to e5m2 in
the backward pass. ``half_batch=True`` is one of the faults the comparison
has to catch: the loss is the mean over half of the batch's positions.

Each layer runs under ``torch.utils.checkpoint``, so a layer's activations
live only while it runs, and the reference fits beside its own state on
one card at the cells' widths. It imports nothing of the program under
test, and takes none of its tensors: it makes its starting point from the
seed (:mod:`perfbench.weights`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import weights as W

__all__ = ["adamw_update", "follow", "loss"]

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _qdq(x: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with one scale for the tensor
    (its largest magnitude maps to ``fmax``), returned in x's dtype."""
    s = x.detach().abs().amax().clamp_min(1e-30) / fmax
    return (x / s).to(dtype).to(x.dtype) * s


class _Fp8Operand(torch.autograd.Function):
    """Forward: rounded to e4m3. Backward: the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return _qdq(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _qdq(g, torch.float8_e5m2, _E5M2_MAX)


class _Ops:
    """The products of one precision."""

    def __init__(self, precision: str):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision must be 'float32' or 'fp8', got {precision!r}")
        self.fp8 = precision == "fp8"

    def mm(self, a, b):
        if not self.fp8:
            return a @ b
        return _Fp8Grad.apply(_Fp8Operand.apply(a) @ _Fp8Operand.apply(b))


def _rms(x, gain, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gain.float())


def _rope(x, sin, cos):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(ops, m, p, x, sin, cos):
    B, S, d = x.shape
    H, Hkv = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or d // H

    def heads(w, n):
        return ops.mm(x, w.float().reshape(d, n * hd)).view(B, S, n, hd).transpose(1, 2)  # (B, n, S, hd)

    q, k, v = heads(p["wq"], H), heads(p["wk"], Hkv), heads(p["wv"], Hkv)
    q, k = _rope(q, sin, cos), _rope(k, sin, cos)
    if Hkv != H:
        k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    scores = ops.mm(q, k.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = ops.mm(probs, v).transpose(1, 2).reshape(B, S, H * hd)
    return ops.mm(out, p["wo"].float().reshape(H * hd, d))


def _mlp(ops, x, w_gate, w_in, w_out):
    return ops.mm(F.silu(ops.mm(x, w_gate.float())) * ops.mm(x, w_in.float()), w_out.float())


def _moe(ops, m, p, x):
    """``(y, aux)`` of the routed experts on ``x (B, S, d)``."""
    B, S, d = x.shape
    E, k = m["num_experts"], m["top_k"]
    x2 = x.reshape(B * S, d)
    probs = torch.softmax(ops.mm(x2, p["router"].float()), dim=-1)
    w_sorted, idx_sorted = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = w_sorted[:, :k], idx_sorted[:, :k]
    if m["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    f = F.one_hot(idx, E).float().mean(dim=(0, 1))
    aux = E * torch.sum(f * probs.mean(dim=0))
    ex = p["experts"]
    y = torch.zeros_like(x2)
    for e in range(E):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = _mlp(ops, x2[rows], ex["w_gate"][e], ex["w_in"][e], ex["w_out"][e])
        y = y.index_add(0, rows, ye * gate[rows, slot, None])
    return y.reshape(B, S, d), aux


def loss(params, m: dict, tokens: torch.Tensor, *, precision: str = "float32", half_batch: bool = False):
    """The training objective of ``tokens (B, S + 1)``: the mean negative
    log-likelihood of ``tokens[:, 1:]`` given ``tokens[:, :-1]`` (plus the
    router term for a MoE model), float32. ``params`` is the tree of
    :func:`perfbench.weights.tree`; its leaves are used in float32."""
    ops = _Ops(precision)
    eps = m["rms_norm_eps"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    B, S = inp.shape
    d = m["d_model"]
    hd = m.get("head_dim") or d // m["num_heads"]
    half = hd // 2
    pos = torch.arange(S, device=tokens.device, dtype=torch.float32)
    freqs = m["rope_base"] ** (-torch.arange(half, device=tokens.device, dtype=torch.float32) / half)
    ang = pos[:, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    h = params["emb"].float()[inp]
    moe = m["family"] == "moe"
    auxes = []

    def layer(h, p):
        h = h + _attention(ops, m, p["attn"], _rms(h, p["ln1"], eps), sin, cos)
        xn = _rms(h, p["ln2"], eps)
        if moe:
            y, aux = _moe(ops, m, p["moe"], xn)
            return h + y, aux
        return h + _mlp(ops, xn, p["mlp"]["w_gate"], p["mlp"]["w_in"], p["mlp"]["w_out"]), None

    for p in params["moe_layers" if moe else "layers"]:
        h, aux = checkpoint(layer, h, p, use_reentrant=False)
        auxes.append(aux)
    logits = ops.mm(_rms(h, params["ln_f"], eps), params["lm_head"].float())
    if half_batch:  # the fault: half of the batch left out, the mean over the rest
        if B > 1:
            logits, tgt = logits[: B // 2], tgt[: B // 2]
        else:
            logits, tgt = logits[:, : S // 2], tgt[:, : S // 2]
    out = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1))
    if moe:
        out = out + m["router_aux_weight"] * torch.stack(auxes).mean()
    return out


def _as(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``."""
    return torch.tensor(x, dtype=dtype).item()


def adamw_update(x, g, mu, nu, step: int, hp: dict):
    """One AdamW update of parameter ``x`` (in place) with gradient ``g``
    and moments ``mu``, ``nu`` (in place), at the rounding points of the
    module docstring; ``hp`` holds ``lr``, ``b1``, ``b2``, ``eps`` and
    ``weight_decay``."""
    b1, b2 = hp["b1"], hp["b2"]
    mu.mul_(_as(b1, mu.dtype)).add_(_as(1 - b1, g.dtype) * g)
    nu.mul_(_as(b2, nu.dtype)).add_(_as(1 - b2, nu.dtype) * g.float().square())
    t = torch.tensor(float(step), dtype=torch.float32, device=x.device)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=x.device) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=x.device) ** t
    u = (mu.float() / bc1) / ((nu / bc2).sqrt() + hp["eps"]) + _as(hp["weight_decay"], x.dtype) * x
    x.add_((-hp["lr"] * u).to(x.dtype))


@contextlib.contextmanager
def _float32_products():
    """Products in full float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def follow(m: dict, hp: dict, seed: int, batches, device, *, precision: str = "float32",
           half_batch: bool = False) -> dict:
    """Training steps from the seed's starting point, one per batch of
    ``batches`` (each ``(B, S + 1)``): ``{"losses": [float], "grad_norms":
    tensor, "change_norms": tensor}``, the norms per leaf of
    :func:`perfbench.weights.layout` (float32, on the CPU): the first
    step's gradient as the optimizer gets it, and the parameters' change
    over all the steps."""
    lay = W.layout(m)
    pdtype = getattr(torch, m["param_dtype"])
    flat = W.make_flat(lay, seed, device, pdtype)
    start = flat.clone()
    leaves = W.views(lay, flat)
    mu = [torch.zeros_like(x, dtype=getattr(torch, hp["mu_dtype"])) for x in leaves]
    nu = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
    losses, grad_norms = [], None
    with _float32_products():
        for step, tokens in enumerate(batches, start=1):
            xs = [x.detach().requires_grad_() for x in leaves]
            with torch.enable_grad():
                value = loss(W.tree(lay, xs), m, tokens, precision=precision, half_batch=half_batch)
                grads = torch.autograd.grad(value, xs)
            losses.append(float(value.detach()))
            if step == 1:
                grad_norms = torch.stack([g.float().norm() for g in grads]).cpu()
            with torch.no_grad():
                for x, g, a, b in zip(leaves, grads, mu, nu):
                    adamw_update(x, g, a, b, step, hp)
            del xs, grads, value
    with torch.no_grad():
        change = torch.stack([(x.float() - x0.float()).norm() for x, x0 in zip(leaves, W.views(lay, start))]).cpu()
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
