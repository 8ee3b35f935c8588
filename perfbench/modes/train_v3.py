"""The training mode of the DeepSeek-V3 cell: a closed loop of the port's
training steps on the published model, checked with forced routing.

As :mod:`perfbench.modes.train`, whose helpers it uses: one object, the
port's ``build_train_step(cfg)`` step with its parameters and AdamW state,
is built from the seed (:mod:`perfbench.weights_v3`: the parameters and
each MoE layer's selection bias, which goes to every step in the batch as
``router_bias`` and which no step writes), driven through its first
``CHECK_STEPS`` steps with the routing recorder on
(``repro_torch.models.moe_dispatch.record_routing``: each MoE layer's
chosen experts, indices only), then back to back through the window, one
fresh batch a step; a traced run then profiles a sub-window of whole
steps. Once the program's state is freed, the reference
(:mod:`perfbench.reference.deepseek_v3`) follows the first steps from the
same starting point and batches, routing each token to the experts the
program chose. :mod:`perfbench.compare` judges the three standard numbers
against the workload's ``limits``; this mode judges ``route_agreement``,
the share of (token, layer) pairs whose experts the reference's own
float32 choice equals, against the workload's ``route_agreement_floor``
(at least it). It builds from its own layout and port config:
:func:`perfbench.modes.train.port_config` refuses MLA and shared experts.
"""

from __future__ import annotations

import gc
import math
import re
import time

import torch

from perfbench import compare, trace, weights, weights_v3
from perfbench.modes.train import CHECK_STEPS, TRACE_MIN_S, _GcPauses, _grad_norms_from_nu
from perfbench.reference import deepseek_v3

__all__ = ["build", "port_config", "program_first_steps", "run"]

# the configuration's model entries the port names otherwise; every other
# entry but the epsilon is a ModelConfig field of the same name
_RENAMED = {"qk_nope_head_dim": "head_dim", "qk_rope_head_dim": "rope_head_dim"}
_PORT_FIXED = {"rms_norm_eps": 1e-6}
_PORT_ADAM = {"b1": 0.9, "eps": 1e-8}


def port_config(config: dict, model: dict):
    """The port's ``ModelConfig`` of the published DeepSeek-V3 for a
    configuration file: the registry's ``deepseek-v3-671b`` with the file's
    widths (``model``), the published router, MLA in every layer, no MTP,
    the file's training settings and its ``port`` route settings; raises
    where the port would compute something the reference does not."""
    from repro_torch.configs import get_config

    train = config["train"]
    bad = {k: v for k, v in _PORT_FIXED.items() if model[k] != v}
    bad.update({k: train[k] for k, v in _PORT_ADAM.items() if train[k] != v})
    if train["mu_dtype"] != model["param_dtype"] or train["nu_dtype"] != "float32":
        bad["moments"] = (train["mu_dtype"], train["nu_dtype"])
    if bad:
        raise RuntimeError(f"{config['arch']}: the port fixes what the configuration sets otherwise: {bad}")
    fields = {_RENAMED.get(k, k): v for k, v in model.items() if k not in _PORT_FIXED}
    return get_config(config["arch"]).replace(
        **fields, num_kv_heads=model["num_heads"], use_mla=True, dense_prefix_mla=True, use_mtp=False,
        router_score="sigmoid", remat=train["remat"], optimizer=train["optimizer"], learning_rate=train["lr"],
        adam_b2=train["b2"], weight_decay=train["weight_decay"], **config.get("port", {}))


def build(config: dict, model: dict, seed: int, device, build_train_step=None) -> dict:
    """The program's training object from the seed: ``{"cfg", "lay",
    "flat", "params", "biases", "step", "opt", "state"}``; ``step`` takes a
    batch of tokens alone and adds the router biases."""
    if build_train_step is None:
        from repro_torch.launch.steps import build_train_step
    cfg = port_config(config, model)
    lay, flat, params, biases = weights_v3.flat_and_split(model, seed, device, cfg.pdtype())
    train_step, opt = build_train_step(cfg)

    def step(p, s, batch):
        return train_step(p, s, {**batch, "router_bias": biases})

    return {"cfg": cfg, "lay": lay, "flat": flat, "params": params, "biases": biases, "step": step, "opt": opt,
            "state": opt.init(params)}


def program_first_steps(obj: dict, batches, seed, hp, device) -> tuple:
    """Runs ``obj``'s step on ``batches`` (one a step) with the routing
    recorder on: ``({"losses", "grad_norms", "change_norms"}, choices,
    params, state)``, the norms per parameter leaf on the CPU, ``choices[step]``
    the MoE layers' chosen experts."""
    from repro_torch.models.moe_dispatch import record_routing

    play = weights_v3.param_layout(obj["lay"])
    params, state = obj["params"], obj["state"]
    n_moe = len(params["moe_layers"])
    losses, grad_norms, choices = [], None, []
    for i, tokens in enumerate(batches):
        with record_routing() as rec:
            params, state, loss = obj["step"](params, state, {"tokens": tokens})
        if len(rec) != n_moe:
            raise RuntimeError(f"the recorder kept {len(rec)} routings in a step of {n_moe} MoE layers")
        choices.append(rec)
        losses.append(loss)
        if i == 0:
            grad_norms = _grad_norms_from_nu([weights.leaf(state.nu, p) for p, _, _ in play], hp["b2"]).cpu()
    with torch.no_grad():
        start = weights.views(obj["lay"], weights.make_flat(obj["lay"], seed, device, obj["cfg"].pdtype()))
        change = torch.stack([(weights.leaf(params, p).float() - x0.float()).norm()
                              for (p, _, _), x0 in zip(obj["lay"], start) if p[0] != weights_v3.BIAS]).cpu()
        del start
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms, "change_norms": change}, choices, params, \
        state


def judge(prog: dict, ref: dict, cell: dict, names) -> tuple:
    """``(correct, checks, numbers)``: the standard numbers against the
    cell's ``limits`` (:func:`perfbench.compare.judge`) and
    ``route_agreement`` at least the cell's ``route_agreement_floor``."""
    numbers = compare.readings(prog, ref, names)
    correct, checks = compare.judge(numbers, cell["limits"])
    agreement, floor = ref["route_agreement"], cell["route_agreement_floor"]
    checks["route_agreement"] = {"value": agreement, "limit": floor, "floor": True}
    return correct and agreement is not None and agreement >= floor, checks, numbers


# the port's config fields this mode sets beyond the JAX package's
_NEEDS = ("router_score", "router_groups", "routed_scale", "num_experts_held", "dense_prefix_mla", "adam_b2")


def run(ctx: dict) -> dict:
    """One run of the cell (:func:`perfbench.modes.train.run`'s ``ctx`` and
    result; ``ctx["model"]``, where given, holds widths in place of the
    configuration's, for tests on the CPU). A port without the published
    model's config fields exits at once with code 2, as the harness does
    for a cell it cannot run."""
    import dataclasses

    from repro_torch.configs import ModelConfig

    missing = sorted(set(_NEEDS) - {f.name for f in dataclasses.fields(ModelConfig)})
    if missing:
        ctx["log"](f"perfbench: the port's ModelConfig has no {missing}: it cannot run {ctx['cell']['name']}")
        raise SystemExit(2)
    cell, config, device, log = ctx["cell"], ctx["config"], torch.device(ctx["device"]), ctx["log"]
    model = ctx.get("model") or config["model"]
    hp = config["train"]
    seed = ctx["seed"]
    on_card = device.type == "cuda"
    B, S = cell["batch"], cell["seq_len"]
    t_build = time.monotonic()
    obj = build(config, model, seed, device, ctx.get("build_train_step"))
    lay, step, flat, biases = obj["lay"], obj["step"], obj["flat"], obj["biases"]
    pool = weights.batch_pool(seed, cell["steps_drawn"], B, S, model["vocab_size"], device)
    check_batches = [pool[i] for i in range(CHECK_STEPS)]
    t_built = time.monotonic()
    prog, choices, params, state = program_first_steps(obj, check_batches, seed, hp, device)
    del obj
    t_checked = time.monotonic()

    window_rows = pool.shape[0] - CHECK_STEPS
    feed = {"next": 0}

    def one():
        nonlocal params, state
        tokens = pool[CHECK_STEPS + feed["next"] % window_rows]
        feed["next"] += 1
        params, state, loss = step(params, state, {"tokens": tokens})
        return loss

    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - ctx["t_start"]
    log(f"[train_v3] set-up {setup_s:.3f} s: imports and the card {t_build - ctx['t_start']:.3f}, weights and AdamW "
        f"state {t_built - t_build:.3f}, the {CHECK_STEPS} checked steps and their readings {t_checked - t_built:.3f}")
    from repro_torch.models import moe_dispatch

    held0 = (moe_dispatch.pairs_held, moe_dispatch.dropped)
    pauses = _GcPauses()
    losses = []
    t0 = time.perf_counter()
    while True:
        losses.append(one())
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    window_pauses = pauses.take()
    steps = len(losses)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    if feed["next"] > window_rows:
        log(f"[train_v3] the window ran {feed['next']} steps on {window_rows} drawn batches: batches repeat")
    tokens_per_s = steps * B * S / window_s
    n_moe = model["num_layers"] - model["dense_prefix_layers"]
    passes = steps * n_moe * (2 if hp["remat"] == "full" else 1)
    log(f"[train_v3] window: Python's full collections {window_pauses}; held route: "
        f"{(moe_dispatch.pairs_held - held0[0]) / passes:.1f} pairs a MoE layer and forward pass (remat's recompute "
        f"one), most in one expert {moe_dispatch.max_load}, "
        f"dropped {moe_dispatch.dropped - held0[1]}")
    log(f"[train_v3] window: {steps} steps of {B} x {S} tokens in {window_s:.6f} s ({window_s / steps * 1e3:.3f} ms "
        f"a step), {tokens_per_s:.3f} tokens/s; set-up {setup_s:.3f} s; peak {window_peak / 2 ** 30:.3f} GiB "
        f"(set-up {setup_peak / 2 ** 30 if on_card else 0:.3f})")

    traced = None
    if ctx["trace"]:
        n = max(2, math.ceil(TRACE_MIN_S * steps / window_s))
        gc.collect()
        pauses.take()
        traced = trace.profile_steps(one, n)
        traced["steps"] = n
        flash = {}
        for name, _, _ in traced["ops"]:
            for kernel in re.findall(r"flash_\w+_kernel<\d+>", name)[:1]:
                flash[kernel] = flash.get(kernel, 0) + 1
        log(f"[train_v3] traced: Python's full collections {pauses.take()}; flash launches a step "
            f"{ {k: v / n for k, v in sorted(flash.items())} }")
        from repro_torch import spans

        by_span = {k: (v["count"] / n, round(1e3 * v["device_s"] / n, 3)) for k, v in sorted(spans.summary().items())
                   if v["device_s"] is not None}
        log(f"[train_v3] traced spans (count, device ms) a step: {by_span}")
        log(f"[train_v3] traced {n} steps: window {traced['window_s']:.6f} s, device busy {traced['busy_s']:.6f} s, "
            f"{len(traced['ops'])} device operations, {traced['gaps']} idle gaps; longest (s, at s, host op): "
            f"{[(round(a, 6), round(b, 6), n) for a, b, n in traced['longest_gaps']]}")

    pauses.close()
    # the router biases, which the steps read and must not write, against the buffer they were cast from
    drawn = weights_v3.split(lay, weights.views(lay, flat))[1]
    bias_kept = all(torch.equal(b, x) for b, x in zip(biases, drawn, strict=True))
    if not bias_kept:
        log("[check] a step wrote into the router biases")
    del params, state, step, pool, one, flat, biases
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = deepseek_v3.follow(model, hp, seed, check_batches, device, choices=choices)
    names = ["/".join(map(str, p)) for p, _, _ in weights_v3.param_layout(lay)]
    correct, checks, numbers = judge(prog, ref, cell, names)
    for name in compare.NUMBERS:
        if name not in checks:
            log(f"[check] not compared: {name} {numbers[name]!r}")
    log(f"[check] reference: {CHECK_STEPS} steps in {time.perf_counter() - t_ref:.3f} s; program losses "
        f"{prog['losses']}, reference {ref['losses']}; worst gradient leaf {numbers['worst_grad_leaf']}, worst "
        f"change leaf {numbers['worst_change_leaf']} ({numbers['leaves_counted']} of {numbers['leaves']} leaves "
        f"counted); route agreement {ref['route_agreement']!r}")
    return {
        "correct": correct and failed == 0 and bias_kept,
        "attempted": steps,
        "failed": failed,
        "end_to_end": {"train_tokens_per_s": tokens_per_s, "train_peak_mem_gib": window_peak / 2 ** 30,
                       "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, window_peak) if on_card else 0,
        "record": {"model": model, "cell": cell, "train": hp, "window": {"steps": steps, "seconds": window_s,
                                                                         "tokens": steps * B * S},
                   "trace": traced},
        "checks": checks,
    }
