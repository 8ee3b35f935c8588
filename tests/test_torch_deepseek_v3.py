"""The published DeepSeek-V3 on the port (arXiv:2412.19437), beyond the JAX
package's model: the sigmoid group-limited router with its selection-only
bias, the layer that holds a share of the routed experts
(``moe_impl="held"``), MLA in the dense prefix layers, flash attention with
v's head dim below q's, the routing recorder, the held route's counters and
the spans inside the layers.

On the CPU at small widths, float32: the router against a hand-worked case;
the port's train step against the benchmark's plain reference
(``perfbench/reference/deepseek_v3.py``) on seeded weights, routed as the
port chose (loss, first gradient, three AdamW steps); the held shares adding
up to the uncut layer; the ``Dv < D`` flash route against plain attention,
forward and gradient; the recorder, the counters and the spans inert by
default and counted as documented under the profiler.

On the card (marked ``cuda``; they skip without one, and import no JAX):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_deepseek_v3.py

MLA's attention through the flash kernels at H = 128, S = 4,096, head dims
192/128 against the plain route, forward and backward; the held route at
4,096 tokens and the published widths against the reference's experts with
nothing dropped, output and gradients; the router bias bit for bit after a
train step.
"""

import math

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.launch import build_train_step
from repro_torch.models import init_params
from repro_torch.models import moe_dispatch as md
from repro_torch.models.layers import attention

# float32 against float32: summation order alone (as perfbench/test_perfbench_reference.py)
RTOL = 2e-5
SMALL_V3 = dict(num_layers=3, dense_prefix_layers=1, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8, v_head_dim=16, d_ff=96, d_ff_expert=32,
                num_experts=16, num_shared_experts=1, top_k=4, router_score="sigmoid", router_groups=4,
                router_groups_kept=2, routed_scale=2.5, dense_prefix_mla=True, use_mla=True, use_mtp=False,
                router_aux_weight=1e-4, vocab_size=256, param_dtype="float32", compute_dtype="float32",
                attn_impl="flash", remat="full", attn_block_q=0, optimizer="adamw", adam_b2=0.95,
                weight_decay=0.1)


def _cfg(**kw):
    return get_config("deepseek-v3-671b", smoke=True).replace(**{**SMALL_V3, **kw})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the flash kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


def test_sigmoid_router_against_a_hand_worked_case():
    """8 experts in 4 groups of 2, 2 groups kept, top 2, scale 2.5, a bias
    of 0.5 on expert 1; the router weight the identity, so the logits are
    the inputs. The selection is on the biased scores, the gates are the
    unbiased ones of the chosen experts over their sum, times 2.5; ties go
    to the lower group and the lower expert."""
    cfg = get_config("deepseek-v3-671b", smoke=True).replace(
        d_model=8, num_experts=8, top_k=2, router_score="sigmoid", router_groups=4, router_groups_kept=2,
        routed_scale=2.5)
    x = torch.tensor([[0.0, 0.1, -1.0, -2.0, 0.3, -3.0, -0.5, 2.0],
                      [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, -5.0, -5.0],
                      [0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6],
                      [-1.0, 0.0, 3.0, -3.0, 0.2, 0.1, 0.0, 0.0]])
    bias = torch.tensor([0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    gate_w, gate_idx, aux = md.route(cfg, x, torch.eye(8), bias, batch=2)
    s = torch.sigmoid(x)
    # token 0: biased scores .500 1.025 | .269 .119 | .574 .047 | .378 .881: group sums 1.525, .388,
    #   .621, 1.259 keep groups 0 and 3; experts 1 (1.025) and 7 (.881), though 4's unbiased .574 > 1's .525
    # token 1: .731 1.231 | .731 .731 | .731 .731 | .007 .007: groups 1 and 2 tie, 1 kept beside 0;
    #   expert 1, then 0 of the tied 0, 2, 3
    # token 2: .550 1.099 | .646 .690 | .731 .769 | .802 .832: groups 0 (1.649) and 3 (1.634); 1 and 7
    # token 3: .269 1.000 | .953 .047 | .550 .525 | .500 .500: groups 0 (1.269) and 2 (1.075); 1 and 4
    want_idx = torch.tensor([[1, 7], [1, 0], [1, 7], [1, 4]])
    assert torch.equal(gate_idx, want_idx)
    chosen = s.gather(1, want_idx)
    assert torch.allclose(gate_w, chosen / chosen.sum(-1, keepdim=True) * 2.5, rtol=0, atol=1e-7)
    # sequence-wise balance: tokens 0-1 and 2-3 each a sequence; E * sum_e f_e P_e, f_e over its 4 pairs
    share = s / s.sum(-1, keepdim=True)
    want = 0.0
    for rows in ((0, 1), (2, 3)):
        f = torch.zeros(8)
        for r in rows:
            f[want_idx[r]] += 1 / 4
        want += 8 * float((f * share[list(rows)].mean(0)).sum()) / 2
    assert float(aux) == pytest.approx(want, rel=1e-6)
    # the bias selects only: no gradient reaches it, and the gates' gradient reaches x
    xg, bg = x.clone().requires_grad_(), bias.clone().requires_grad_()
    w, _, a = md.route(cfg, xg, torch.eye(8), bg, batch=2)
    (w.sum() + a).backward()
    assert bg.grad is None and xg.grad is not None


def test_the_softmax_router_refuses_the_sigmoid_routers_settings():
    with pytest.raises(ValueError, match="sigmoid router"):
        get_config("olmoe-1b-7b", smoke=True).replace(router_groups=2)
    with pytest.raises(ValueError, match="not among"):
        get_config("olmoe-1b-7b", smoke=True).replace(num_experts_held=2, first_expert_held=7)


# ---------------------------------------------------------------------------
# the train step against the plain reference
# ---------------------------------------------------------------------------


def _reference_model(cfg):
    """The perfbench model dict of a port config (the reference's names)."""
    return {"family": "moe", "num_layers": cfg.num_layers, "dense_prefix_layers": cfg.dense_prefix_layers,
            "d_model": cfg.d_model, "num_heads": cfg.num_heads, "q_lora_rank": cfg.q_lora_rank,
            "kv_lora_rank": cfg.kv_lora_rank, "qk_nope_head_dim": cfg.hd, "qk_rope_head_dim": cfg.rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "d_ff": cfg.d_ff, "d_ff_expert": cfg.d_ff_expert,
            "num_shared_experts": cfg.num_shared_experts, "num_experts": cfg.num_experts,
            "num_experts_held": cfg.experts_held, "first_expert_held": cfg.first_expert_held, "top_k": cfg.top_k,
            "router_groups": cfg.router_groups, "router_groups_kept": cfg.router_groups_kept,
            "routed_scale": cfg.routed_scale, "router_aux_weight": cfg.router_aux_weight,
            "vocab_size": cfg.vocab_size, "rope_base": cfg.rope_base, "rms_norm_eps": 1e-6, "tie_embeddings": False,
            "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype}


def test_train_step_matches_the_plain_reference():
    """Seeded weights (perfbench.weights_v3), 4 of 16 experts held from
    expert 4, float32: the loss and every leaf's first gradient within
    RTOL of the reference routed as the port chose, the choices equal to
    the reference's own, then three AdamW steps (beta2 0.95, weight decay
    0.1): the losses and each leaf's change norm."""
    from perfbench import weights, weights_v3
    from perfbench.reference import deepseek_v3 as ref
    from repro_torch.launch import value_and_grad

    cfg = _cfg(num_experts_held=4, first_expert_held=4, moe_impl="held")
    m = _reference_model(cfg)
    hp = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "mu_dtype": "float32",
          "optimizer": "adamw", "remat": "full"}
    seed = 2 ** 31 + 5
    lay, flat, params, biases = weights_v3.flat_and_split(m, seed, "cpu", torch.float32)
    play = weights_v3.param_layout(lay)
    batches = [weights.batch_pool(seed, 3, 2, 24, m["vocab_size"], "cpu")[i] for i in range(3)]

    with md.record_routing() as rec:
        loss_p, grads_p = value_and_grad(params, cfg, {"tokens": batches[0], "router_bias": biases})
    xs = [weights.leaf(params, p).detach().clone().requires_grad_() for p, _, _ in play]
    own = []
    loss_r = ref.loss(weights.tree(play, xs), biases, m, batches[0], forced=rec, own=own)
    grads_r = torch.autograd.grad(loss_r, xs)
    assert [torch.equal(a, b) for a, b in zip(rec, own)] == [True] * len(rec)
    assert float(loss_p) == pytest.approx(float(loss_r.detach()), rel=RTOL)
    for (path, _, _), g_r in zip(play, grads_r):
        g_p = weights.leaf(grads_p, path)
        assert float((g_p - g_r).abs().max()) <= RTOL * float(g_r.abs().max()) + 1e-12, path

    step, opt = build_train_step(cfg.replace(learning_rate=hp["lr"]))
    state = opt.init(params)
    losses = []
    for tokens in batches:
        params, state, loss = step(params, state, {"tokens": tokens, "router_bias": biases})
        losses.append(float(loss))
    got = ref.follow(m, hp, seed, batches, "cpu")
    assert got["losses"] == pytest.approx(losses, rel=RTOL)
    start = weights.views(lay, weights.make_flat(lay, seed, "cpu", torch.float32))
    change = torch.stack([(weights.leaf(params, p) - x0).norm() for (p, _, _), x0 in zip(lay, start)
                          if p[0] != weights_v3.BIAS])
    assert torch.allclose(change, got["change_norms"], rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the chip's share of the experts
# ---------------------------------------------------------------------------


def test_held_shares_add_up_to_the_uncut_layer():
    """16 experts in 4 shares of 4: the held route's outputs of all 4
    shares, the shared expert counted once, add up to the plain reference's
    layer holding all 16 (float32)."""
    from perfbench.reference import deepseek_v3 as ref
    from perfbench.reference.decoder import _Ops

    cfg = _cfg()
    p = init_params(cfg.replace(num_layers=2), 3, device="cpu")["moe_layers"][0]["moe"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 40, cfg.d_model, generator=gen)
    bias = torch.randn(cfg.num_experts, generator=gen) * 0.05
    m = dict(_reference_model(cfg), num_experts_held=16, first_expert_held=0)
    want, _, _ = ref._moe(_Ops("float32"), m, p, x, bias, None, None)
    shared = ref._mlp(_Ops("float32"), x.reshape(-1, cfg.d_model), p["shared"]).reshape(x.shape)
    held = 4
    total = -(cfg.num_experts // held - 1) * shared
    before = md.pairs_held
    for first in range(0, cfg.num_experts, held):
        c = cfg.replace(moe_impl="held", num_experts_held=held, first_expert_held=first)
        part = {**p, "experts": {k: w[first:first + held] for k, w in p["experts"].items()}}
        y, _ = md.moe_ffn(c, part, x, bias)
        total = total + y
    assert md.pairs_held - before == x.shape[0] * x.shape[1] * cfg.top_k  # every pair on exactly one share
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)


def test_held_route_gradients_with_an_expert_no_pair_reaches():
    """4 of 16 experts held, expert 5 kept out of every selection by its
    bias: the held route's output and the gradients of x, the gates' router
    and each held expert against the reference's layer (float32), expert
    5's gradient exactly zero, and the pairs counted."""
    from perfbench.reference import deepseek_v3 as ref
    from perfbench.reference.decoder import _Ops

    cfg = _cfg(moe_impl="held", num_experts_held=4, first_expert_held=4)
    p = init_params(cfg.replace(num_layers=2), 5, device="cpu")["moe_layers"][0]["moe"]
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 40, cfg.d_model, generator=gen)
    bias = torch.randn(cfg.num_experts, generator=gen) * 0.05
    bias[5] = -10.0
    cot = torch.randn(x.shape, generator=gen)
    m = dict(_reference_model(cfg))
    grads = []
    for side in ("port", "reference"):
        xs = x.clone().requires_grad_()
        leaves = {n: w.detach().clone().requires_grad_() for n, w in p["experts"].items()}
        router = p["router"].detach().clone().requires_grad_()
        q = {**p, "router": router, "experts": leaves}
        before = md.pairs_held
        if side == "port":
            with md.record_routing() as rec:
                y, _ = md.moe_ffn(cfg, q, xs, bias)
            assert md.pairs_held - before == int(((rec[0] >= 4) & (rec[0] < 8)).sum()) > 0
            assert not bool((rec[0] == 5).any())
        else:
            y, _, _ = ref._moe(_Ops("float32"), m, q, xs, bias, rec[0], None)
        (y * cot).sum().backward()
        grads.append([xs.grad, router.grad] + [leaves[n].grad for n in ("w_gate", "w_in", "w_out")])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    assert all(float(g[1].abs().max()) == 0.0 for g in grads[0][2:])


def test_a_layer_holding_a_share_runs_only_the_held_route():
    cfg = _cfg(num_experts_held=4)
    p = init_params(cfg.replace(num_layers=2), 0, device="cpu")["moe_layers"][0]["moe"]
    assert p["experts"]["w_gate"].shape[0] == 4 and p["router"].shape[1] == 16
    with pytest.raises(ValueError, match="held"):
        md.moe_ffn(cfg, p, torch.randn(1, 8, cfg.d_model))


# ---------------------------------------------------------------------------
# flash attention with v's head dim below q's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D, Dv", [(24, 16), (48, 32)])
def test_flash_route_takes_v_head_dim_below_q(D, Dv):
    """The flash route (the kernels' plain version on the CPU) on v
    zero-padded to q's head dim against the plain route: output and the
    gradients of q, k and v, MLA's scale."""
    gen = torch.Generator().manual_seed(D)
    B, S, H = 2, 40, 3
    q, k = (torch.randn(B, S, H, D, generator=gen, dtype=torch.float64).float() for _ in range(2))
    v = torch.randn(B, S, H, Dv, generator=gen)
    pos = torch.arange(S)
    outs, grads = [], []
    for impl in ("flash", "plain"):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = attention(*xs, q_pos=pos, kv_pos=pos, kind="causal", scale=D ** -0.5, impl=impl)
        assert o.shape == (B, S, H, Dv)
        (o * torch.linspace(-1, 1, Dv)).sum().backward()
        outs.append(o.detach())
        grads.append([t.grad for t in xs])
    torch.testing.assert_close(outs[0], outs[1], rtol=2e-5, atol=2e-6)
    for a, b in zip(*grads):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-5)


# ---------------------------------------------------------------------------
# inert by default; the spans under the profiler
# ---------------------------------------------------------------------------


def test_recorder_counters_and_spans_are_inert_by_default():
    """Without record_routing, route keeps nothing; the softmax router and
    the dense route leave the held route's counters alone; without the
    profiler no span records."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    p = init_params(cfg, 0, device="cpu")["moe_layers"][0]["moe"]
    counters = (md.pairs_held, md.max_load, md.dropped)
    spans.reset()
    md.moe_ffn(cfg, p, torch.randn(1, 16, cfg.d_model))
    assert md._recorded is None
    assert (md.pairs_held, md.max_load, md.dropped) == counters
    assert spans.summary() == {}
    with md.record_routing() as rec:
        md.moe_ffn(cfg, p, torch.randn(1, 16, cfg.d_model))
    assert len(rec) == 1 and rec[0].shape == (16, cfg.top_k) and md._recorded is None


def test_spans_in_the_layers_under_remat():
    """Two traced steps of 3 layers (1 dense MLA, 2 MoE held): each forward
    span twice a layer and step (the forward and remat's recompute), each
    backward span once, items tokens; the loss head's spans once a step; no
    recompute inside a backward span, and no two backward spans overlapping;
    the recorder keeps one routing a MoE layer and step; the held route
    drops nothing, and remat's recompute takes the forward pass's counts."""
    cfg = _cfg(num_experts_held=4, first_expert_held=4, moe_impl="held")
    params = init_params(cfg, 0, device="cpu")
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(0))
    bias = [torch.zeros(cfg.num_experts) for _ in range(2)]
    dropped = md.dropped
    spans.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), md.record_routing() as rec:
        for _ in range(2):
            params, state, _ = step(params, state, {"tokens": tokens, "router_bias": bias})
    got = spans.summary()
    records = list(spans._records)
    spans.reset()
    n_tok, steps = 2 * 32, 2
    for name, layers in (("attn.mla", 3), ("moe.route", 2), ("moe.held", 2), ("moe.shared", 2)):
        assert got[name]["count"] == steps * layers * 2 and got[name]["items"] == steps * layers * 2 * n_tok, name
        assert got[name + ".bwd"]["count"] == steps * layers, name
        assert got[name + ".bwd"]["items"] == steps * layers * n_tok, name
    for name in ("model.loss_head", "model.loss_head.bwd"):
        assert got[name]["count"] == steps and got[name]["items"] == steps * n_tok, name
    backward = [r for r in records if r.name.endswith(".bwd") and r.name.split(".")[0] in ("attn", "moe")]
    forward = [r for r in records if r.name in ("attn.mla", "moe.route", "moe.held", "moe.shared")]
    assert not [(f.name, b.name) for f in forward for b in backward if b.t0 <= f.t0 and f.t1 <= b.t1]
    # the layers' backward spans never overlap, so their sum counts no time twice
    spans_in_order = sorted(backward, key=lambda r: r.t0)
    assert all(a.t1 <= b.t0 for a, b in zip(spans_in_order, spans_in_order[1:]))
    assert len(rec) == steps * 2 and md.dropped == dropped
    assert not md._held_memo  # each forward pass's counts taken by its recompute
    assert all(torch.equal(b, torch.zeros(cfg.num_experts)) for b in bias)


def test_held_counters_count_remats_recompute_as_a_forward_pass():
    """A train step under remat "full", the profiler off: ``pairs_held``
    grows by twice the held pairs of the recorded choices (the forward pass
    and the recompute, which stops early, at the layer's last saved
    tensor), ``max_load`` is their busiest expert's count, nothing drops."""
    cfg = _cfg(num_experts_held=4, first_expert_held=4, moe_impl="held")
    params = init_params(cfg, 1, device="cpu")
    step, opt = build_train_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(3))
    bias = [torch.zeros(cfg.num_experts) for _ in range(2)]
    md.max_load = 0
    before = (md.pairs_held, md.dropped)
    with md.record_routing() as rec:
        step(params, opt.init(params), {"tokens": tokens, "router_bias": bias})
    held = [((c >= 4) & (c < 8)) for c in rec]
    assert md.pairs_held - before[0] == 2 * sum(int(h.sum()) for h in held) > 0
    assert md.max_load == max(int((c[h] == e).sum()) for c, h in zip(rec, held) for e in range(4, 8))
    assert md.dropped == before[1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_mla_attention_through_flash_on_the_card(cuda):
    """H = 128, S = 4,096, q/k head dim 192, v 128, bf16: one forward, dQ
    and dK/dV launch on the tensor cores (the 256 instance), the output and
    the gradients against the plain route on float32 copies within bf16's
    tolerance (2e-2, tests/test_flash_attention.py's bf16 bar)."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=cuda).manual_seed(0)
    B, S, H, D, Dv = 1, 4096, 128, 192, 128
    q, k = (torch.randn(B, S, H, D, generator=gen, device=cuda).bfloat16() for _ in range(2))
    v = torch.randn(B, S, H, Dv, generator=gen, device=cuda).bfloat16()
    do = torch.randn(B, S, H, Dv, generator=gen, device=cuda).bfloat16()
    pos = torch.arange(S, device=cuda)
    before = (fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = attention(*xs, q_pos=pos, kv_pos=pos, kind="causal", scale=D ** -0.5, impl="flash")
    o.backward(do)
    assert (fa.launches_fwd_tc, fa.launches_dq_tc, fa.launches_dkv_tc) == tuple(b + 1 for b in before)
    got = [o.detach().float()] + [t.grad.float() for t in xs]
    del xs, o
    rs = [t.float().requires_grad_() for t in (q, k, v)]
    o = attention(*rs, q_pos=pos, kv_pos=pos, kind="causal", scale=D ** -0.5, impl="plain", block_q=1024)
    o.backward(do.float())
    want = [o.detach()] + [t.grad for t in rs]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 2e-2, (name, err)


@pytest.mark.cuda
def test_held_route_at_the_published_widths_on_the_card(cuda):
    """4,096 tokens, d 7,168, 256 experts routed top-8 in 8 groups keeping 4,
    experts 0-7 held at width 2,048, bf16: every pair routed to them computed
    (``pairs_held`` their count, ``dropped`` 0), the output against the
    reference's experts on float32 copies, routed the same, and the
    gradients of x and of each held expert's weights (the grouped products'
    backward) within 1e-2 of the reference's by norm."""
    from perfbench.reference import deepseek_v3 as ref
    from perfbench.reference.decoder import _Ops

    cfg = get_config("deepseek-v3-671b").replace(
        router_score="sigmoid", router_groups=8, router_groups_kept=4, routed_scale=2.5, num_experts_held=8,
        first_expert_held=0, moe_impl="held", param_dtype="bfloat16", compute_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(1)
    d, E, fe = cfg.d_model, cfg.num_experts, cfg.d_ff_expert

    def w(*shape, fan):
        return (torch.randn(*shape, generator=gen, device=cuda) / math.sqrt(fan)).bfloat16()

    p = {"router": w(d, E, fan=d), "experts": {"w_gate": w(8, d, fe, fan=d), "w_in": w(8, d, fe, fan=d),
                                                "w_out": w(8, fe, d, fan=fe)},
         "shared": {"w_gate": w(d, fe, fan=d), "w_in": w(d, fe, fan=d), "w_out": w(fe, d, fan=fe)}}
    x = torch.randn(1, 4096, d, generator=gen, device=cuda).bfloat16()
    bias = torch.randn(E, generator=gen, device=cuda) / math.sqrt(d)
    before = (md.pairs_held, md.dropped)
    leaves = {n: w.clone().requires_grad_() for n, w in p["experts"].items()}
    xs = x.clone().requires_grad_()
    with md.record_routing() as rec:
        y, _ = md.moe_ffn(cfg, {**p, "experts": leaves}, xs, bias)
    n_held = int((rec[0] < 8).sum())
    assert md.pairs_held - before[0] == n_held > 0 and md.dropped == before[1]
    cot = torch.randn(y.shape, generator=gen, device=cuda).bfloat16()
    y.backward(cot)
    m = {"num_experts": E, "top_k": 8, "router_groups": 8, "router_groups_kept": 4, "routed_scale": 2.5,
         "num_experts_held": 8, "first_expert_held": 0}
    wants = {n: w.float().requires_grad_() for n, w in p["experts"].items()}
    xf = x.float().requires_grad_()
    want, _, _ = ref._moe(_Ops("float32"), m, {**p, "experts": wants}, xf, bias, rec[0], None)
    want.backward(cot.float())
    err = float((y.float() - want).abs().max()) / float(want.abs().max())
    assert err <= 2e-2, err
    # the grouped products' backward, expert by expert (the norm of the gap over the norm)
    for name, g, w in [("x", xs.grad, xf.grad)] + [(n, leaves[n].grad, wants[n].grad) for n in leaves]:
        for e in range(g.shape[0] if name != "x" else 1):
            a, b = (g[e], w[e]) if name != "x" else (g, w)
            gap = float((a.float() - b).norm() / b.norm())
            assert gap <= 1e-2, (name, e, gap)


@pytest.mark.cuda
def test_router_bias_is_unchanged_bit_for_bit_by_a_step(cuda):
    cfg = _cfg(num_experts_held=4, first_expert_held=4, moe_impl="held", param_dtype="bfloat16",
               compute_dtype="bfloat16")
    params = init_params(cfg, 0, device=cuda)
    step, opt = build_train_step(cfg)
    state = opt.init(params)
    bias = [torch.randn(cfg.num_experts, device=cuda) * 0.05 for _ in range(2)]
    kept = [b.clone() for b in bias]
    router = params["moe_layers"][0]["moe"]["router"].clone()
    tokens = torch.randint(0, cfg.vocab_size, (1, 129), device=cuda)
    params, state, loss = step(params, state, {"tokens": tokens, "router_bias": bias})
    torch.cuda.synchronize()
    assert math.isfinite(float(loss))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(bias, kept))
    assert not torch.equal(params["moe_layers"][0]["moe"]["router"], router)
