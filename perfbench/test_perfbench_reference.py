"""The plain reference against the port, on the CPU at small widths: the
loss and every gradient of both families in float32, and the AdamW update
at the configuration's rounding points bit for bit."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import weights
from perfbench.modes.train import port_config
from perfbench.reference import decoder

CONFIGS = Path(__file__).resolve().parent / "configs"
SMALL = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96, vocab_size=256)
SMALL_MOE = dict(num_experts=8, top_k=2, d_ff_expert=32)
# float32 against float32 over two layers: summation order alone (measured
# 1.2e-6 of each leaf's largest gradient)
RTOL = 2e-5


def small(name, **kw):
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    m = dict(config["model"], **SMALL, **kw)
    if m["family"] == "moe":
        m.update(SMALL_MOE)
    return config, m


@pytest.mark.parametrize("name", ["deepseek-7b", "olmoe-1b-7b"])
def test_reference_loss_and_gradients_match_the_port(name):
    from repro_torch.launch.steps import value_and_grad

    config, m = small(name, param_dtype="float32", compute_dtype="float32")
    cfg = port_config(config, m).replace(remat="none")
    lay = weights.layout(m)
    flat = weights.make_flat(lay, 11, "cpu", torch.float32)
    tokens = weights.batch_pool(11, 1, 2, 32, m["vocab_size"], "cpu")[0]
    loss_p, grads_p = value_and_grad(weights.tree(lay, weights.views(lay, flat)), cfg, {"tokens": tokens})
    xs = [x.detach().clone().requires_grad_() for x in weights.views(lay, flat)]
    loss_r = decoder.loss(weights.tree(lay, xs), m, tokens)
    grads_r = torch.autograd.grad(loss_r, xs)
    assert float(loss_p) == pytest.approx(float(loss_r.detach()), rel=RTOL)
    for (path, _, _), g_r in zip(lay, grads_r):
        g_p = weights.leaf(grads_p, path)
        assert float((g_p - g_r).abs().max()) <= RTOL * float(g_r.abs().max()), path


def test_reference_adamw_matches_the_port_bit_for_bit():
    from repro_torch.optim import apply_updates, get_optimizer

    config, m = small("deepseek-7b")
    hp = config["train"]
    lay = weights.layout(m)
    port_p = weights.tree(lay, weights.views(lay, weights.make_flat(lay, 3, "cpu", torch.bfloat16)))
    ref_x = weights.views(lay, weights.make_flat(lay, 3, "cpu", torch.bfloat16))
    opt = get_optimizer(hp["optimizer"], hp["lr"])
    state = opt.init(port_p)
    mu = [torch.zeros_like(x) for x in ref_x]
    nu = [torch.zeros_like(x, dtype=torch.float32) for x in ref_x]
    gen = torch.Generator().manual_seed(4)
    for step in (1, 2, 3):
        grads = [torch.randn(x.shape, generator=gen).mul_(1e-3 * step).to(torch.bfloat16) for x in ref_x]
        updates, state = opt.update(weights.tree(lay, grads), state, port_p)
        port_p = apply_updates(port_p, updates)
        for x, g, a, b in zip(ref_x, grads, mu, nu):
            decoder.adamw_update(x, g, a, b, step, hp)
    for (path, _, _), x, a, b in zip(lay, ref_x, mu, nu):
        assert torch.equal(weights.leaf(port_p, path), x), path
        assert torch.equal(weights.leaf(state.mu, path), a), path
        assert torch.equal(weights.leaf(state.nu, path), b), path


def test_the_control_and_the_half_batch_fault_move_the_reference():
    """The float8 control and the half-batch loss each change what the
    float32 reference reads (their size on the card sets the limits; see
    PERF.md)."""
    from perfbench import compare

    config, m = small("olmoe-1b-7b")
    tokens = [weights.batch_pool(5, 3, 2, 32, m["vocab_size"], "cpu")[i] for i in range(3)]
    ref = decoder.follow(m, config["train"], 5, tokens, "cpu")
    for kw in (dict(precision="fp8"), dict(half_batch=True)):
        got = compare.readings(decoder.follow(m, config["train"], 5, tokens, "cpu", **kw), ref)
        assert got["loss_rel_gap"] > 1e-4 and got["grad_norm_gap"] > 1e-2, (kw, got)
