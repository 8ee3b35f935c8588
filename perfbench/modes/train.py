"""The training mode: a closed loop of the port's training steps.

One object, the port's ``build_train_step(cfg)`` step with its parameters
and AdamW state, is built from the seed and driven through its first
``CHECK_STEPS`` steps, which warm every shape the window uses and give the
program's side of the correctness check; the same object then runs back to
back through the window, one fresh batch a step, with no host sync of the
harness's own until the window closes. A traced run then profiles a
sub-window of whole steps. Once the program's state is freed, the reference
(:mod:`perfbench.reference.decoder`) follows the first steps from the same
starting point and batches, and :mod:`perfbench.compare` judges.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from perfbench import compare, trace, weights
from perfbench.reference import decoder

__all__ = ["CHECK_STEPS", "TRACE_MIN_S", "build", "check_layout", "port_config", "program_first_steps", "run"]

CHECK_STEPS = 3
# the traced sub-window: whole steps, at least this long, so that one host
# stall of 0.1 s moves the idle share by 2 points at most
TRACE_MIN_S = 5.0

# the model entries a configuration file states, by the port's field names
_WIDTHS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
           "mlp_kind", "rope_base", "tie_embeddings", "num_experts", "top_k", "d_ff_expert", "router_aux_weight",
           "param_dtype", "compute_dtype")
# the port's fixed RMSNorm epsilon (models/layers.py::rms_norm); it always
# renormalises the top-k gates (models/moe_dispatch.py::route)
_PORT_RMS_EPS = 1e-6
# what the reference models and the port must therefore not switch on
_ABSENT = {"attn_kind": "causal", "logit_softcap": 0.0, "attn_softcap": 0.0, "scale_embedding": False,
           "num_shared_experts": 0, "dense_prefix_layers": 0, "use_mla": False, "use_mtp": False}


def port_config(config: dict, model: dict):
    """The port's ``ModelConfig`` for a configuration file: the registry's
    entry for ``config["arch"]`` with the file's widths (``model``), its
    training settings and its ``port`` route settings; raises if the
    result departs from what the reference computes."""
    from repro_torch.configs import get_config

    train = config["train"]
    fields = {k: model[k] for k in _WIDTHS if k in model}
    cfg = get_config(config["arch"]).replace(**fields, remat=train["remat"], optimizer=train["optimizer"],
                                             learning_rate=train["lr"], **config.get("port", {}))
    bad = {k: getattr(cfg, k) for k, v in _ABSENT.items() if getattr(cfg, k) != v}
    if model["rms_norm_eps"] != _PORT_RMS_EPS:
        bad["rms_norm_eps"] = _PORT_RMS_EPS
    if model["family"] == "moe" and not model["norm_topk_prob"]:
        bad["norm_topk_prob"] = True
    if bad or cfg.hd != (model.get("head_dim") or model["d_model"] // model["num_heads"]):
        raise RuntimeError(f"{config['arch']}: the port's config departs from the reference's model: {bad}")
    return cfg


def _grad_norms_from_nu(nu_leaves, b2: float) -> torch.Tensor:
    """Per-leaf norms of the first gradient, from AdamW's second moment
    after one step, ``nu = (1 - b2) g**2`` in float32."""
    one_minus_b2 = torch.tensor(1 - b2, dtype=torch.float32).item()
    return torch.stack([(v.sum(dtype=torch.float32) / one_minus_b2).sqrt() for v in nu_leaves])


def program_first_steps(step, params, state, batches, lay, seed, hp, device, pdtype):
    """Runs ``step`` on ``batches`` (one per step) and reads the program's
    side of the check: ``({"losses", "grad_norms", "change_norms"},
    params, state)``, the norms per leaf of ``lay`` on the CPU."""
    losses, grad_norms = [], None
    for i, tokens in enumerate(batches):
        params, state, loss = step(params, state, {"tokens": tokens})
        losses.append(loss)
        if i == 0:
            grad_norms = _grad_norms_from_nu([weights.leaf(state.nu, p) for p, _, _ in lay], hp["b2"]).cpu()
    with torch.no_grad():
        start = weights.make_flat(lay, seed, device, pdtype)
        now = [weights.leaf(params, p) for p, _, _ in lay]
        change = torch.stack([(x.float() - x0.float()).norm()
                              for x, x0 in zip(now, weights.views(lay, start))]).cpu()
        del start
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms, "change_norms": change}, params, state


def check_layout(cfg, lay, device="cpu"):
    """The benchmark's layout against the port's parameter tree (shapes and
    dtypes of fake tensors, nothing allocated); raises on a difference.
    The tests run it; a run does not pay for it."""
    from repro_torch.launch.steps import abstract_params
    from repro_torch.optim import tree_leaves

    ref = abstract_params(cfg, device=device)
    for path, shape, _ in lay:
        x = weights.leaf(ref, path)
        if tuple(x.shape) != shape or x.dtype != cfg.pdtype():
            raise RuntimeError(f"parameter {'/'.join(map(str, path))}: the port has {tuple(x.shape)} {x.dtype}, "
                               f"the benchmark's layout {shape} {cfg.pdtype()}")
    n_port = len(tree_leaves(ref))
    if n_port != len(lay):
        raise RuntimeError(f"the port's parameter tree has {n_port} leaves, the benchmark's layout {len(lay)}")


def build(config: dict, model: dict, seed: int, device, build_train_step=None) -> dict:
    """The program's training object from the seed: ``{"cfg", "lay",
    "flat", "params", "step", "opt", "state"}``, the parameters views of
    ``flat`` (:mod:`perfbench.weights`), the step the port's
    ``build_train_step`` unless one is given."""
    if build_train_step is None:
        from repro_torch.launch.steps import build_train_step
    cfg = port_config(config, model)
    lay = weights.layout(model)
    flat = weights.make_flat(lay, seed, device, cfg.pdtype())
    params = weights.tree(lay, weights.views(lay, flat))
    step, opt = build_train_step(cfg)
    return {"cfg": cfg, "lay": lay, "flat": flat, "params": params, "step": step, "opt": opt,
            "state": opt.init(params)}


class _GcPauses:
    """The interpreter's full (generation 2) collections while it is open:
    each pauses the host, and a step that waits on the host leaves the
    device idle. :meth:`take` returns ``(count, seconds)`` since the last
    take."""

    def __init__(self):
        self._start, self._count, self._seconds = 0.0, 0, 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self._count += 1
            self._seconds += time.perf_counter() - self._start

    def take(self) -> tuple:
        out = (self._count, round(self._seconds, 6))
        self._count, self._seconds = 0, 0.0
        return out

    def close(self):
        gc.callbacks.remove(self._on)


def run(ctx: dict) -> dict:
    """One run of a training cell. ``ctx``: ``seed``, ``seconds``,
    ``trace``, ``cell``, ``config``, ``device``, ``t_start`` (the
    process's start, ``time.monotonic()``), ``log``; optionally ``model``
    (widths in place of the configuration's, for tests on the CPU) and
    ``build_train_step`` (in place of the port's)."""
    cell, config, device, log = ctx["cell"], ctx["config"], torch.device(ctx["device"]), ctx["log"]
    model = ctx.get("model") or config["model"]
    hp = config["train"]
    seed = ctx["seed"]
    on_card = device.type == "cuda"
    B, S = cell["batch"], cell["seq_len"]
    t_build = time.monotonic()
    prog_obj = build(config, model, seed, device, ctx.get("build_train_step"))
    lay, flat, step, opt = prog_obj["lay"], prog_obj["flat"], prog_obj["step"], prog_obj["opt"]
    pool = weights.batch_pool(seed, cell["steps_drawn"], B, S, model["vocab_size"], device)
    check_batches = [pool[i] for i in range(CHECK_STEPS)]
    t_built = time.monotonic()
    prog, params, state = program_first_steps(step, prog_obj["params"], prog_obj["state"], check_batches, lay, seed,
                                              hp, device, prog_obj["cfg"].pdtype())
    del prog_obj
    t_checked = time.monotonic()

    window_rows = pool.shape[0] - CHECK_STEPS
    feed = {"next": 0}

    def one():
        nonlocal params, state
        tokens = pool[CHECK_STEPS + feed["next"] % window_rows]
        feed["next"] += 1
        params, state, loss = step(params, state, {"tokens": tokens})
        return loss

    # each measurement starts right after a full collection, so where the
    # interpreter's next one falls does not depend on what set-up allocated
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - ctx["t_start"]
    log(f"[train] set-up {setup_s:.3f} s: imports and the card {t_build - ctx['t_start']:.3f}, weights and AdamW "
        f"state {t_built - t_build:.3f}, the {CHECK_STEPS} checked steps and their readings {t_checked - t_built:.3f}")
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
        log(f"[train] the window ran {feed['next']} steps on {window_rows} drawn batches: batches repeat")
    tokens_per_s = steps * B * S / window_s
    log(f"[train] window: Python's full collections {window_pauses}")
    log(f"[train] window: {steps} steps of {B} x {S} tokens in {window_s:.6f} s ({window_s / steps * 1e3:.3f} ms a "
        f"step), {tokens_per_s:.3f} tokens/s; set-up {setup_s:.3f} s; peak {window_peak / 2 ** 30:.3f} GiB "
        f"(set-up {setup_peak / 2 ** 30 if on_card else 0:.3f})")

    traced = None
    if ctx["trace"]:
        n = max(2, math.ceil(TRACE_MIN_S * steps / window_s))
        gc.collect()
        pauses.take()
        traced = trace.profile_steps(one, n)
        traced["steps"] = n
        log(f"[train] traced: Python's full collections {pauses.take()}")
        log(f"[train] traced {n} steps: window {traced['window_s']:.6f} s, device busy {traced['busy_s']:.6f} s, "
            f"{len(traced['ops'])} device operations, {traced['gaps']} idle gaps; longest (s, at s, host op): "
            f"{[(round(a, 6), round(b, 6), n) for a, b, n in traced['longest_gaps']]}")

    pauses.close()
    del params, state, step, opt, flat, pool, one
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = decoder.follow(model, hp, seed, check_batches, device)
    names = ["/".join(map(str, p)) for p, _, _ in lay]
    numbers = compare.readings(prog, ref, names)
    correct, checks = compare.judge(numbers, cell["limits"])
    for name in compare.NUMBERS:
        if name not in checks:
            log(f"[check] not compared: {name} {numbers[name]!r}")
    log(f"[check] reference: {CHECK_STEPS} steps in {time.perf_counter() - t_ref:.3f} s; program losses "
        f"{prog['losses']}, reference {ref['losses']}; worst gradient leaf {numbers['worst_grad_leaf']}, worst "
        f"change leaf {numbers['worst_change_leaf']} ({numbers['leaves_counted']} of {numbers['leaves']} leaves "
        f"counted)")
    return {
        "correct": correct and failed == 0,
        "attempted": steps,
        "failed": failed,
        "end_to_end": {"train_tokens_per_s": tokens_per_s, "train_peak_mem_gib": window_peak / 2 ** 30,
                       "setup_s": setup_s},
        "memory_peak_bytes": max(setup_peak, window_peak) if on_card else 0,
        "record": {"model": model, "cell": cell, "window": {"steps": steps, "seconds": window_s,
                                                           "tokens": steps * B * S}, "trace": traced},
        "checks": checks,
    }
