"""The DeepSeek-V3 cell on the CPU: it resolves through the registry with
its own mode and metrics; its configuration holds every number of the
published config.json, changed only where ``reduced`` says; its layout is
the port's parameter tree; its work counts agree with a hand count; the
readers read what their spans give and nothing on a run without them; the
reference and the files beside it load nothing of the program; and at
small widths the check passes a sound run and fails the faults and the
control, which read far from it."""

import ast
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from perfbench import compare, faults, registry, weights, weights_v3, work, work_v3
from perfbench.modes import train, train_v3
from perfbench.reference import deepseek_v3

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CELL = "deepseek-v3.train-4k"
CONFIG = json.loads((HERE / "configs" / "deepseek-v3.json").read_text())
MODEL = CONFIG["model"]
READERS = ("mfu.train_v3", "flash_roofline_pct.train_v3", "moe_ms.train_v3", "mla_ms.train_v3")


def _reader(name):
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_cell_resolves_with_its_mode_and_metrics():
    plan = registry.plan(CELL, ROOT)
    assert plan["mode"] is train_v3
    assert set(plan["per_layer"]) == {*READERS, "device_idle_pct.train", "loss_head_ms.train"}
    assert [m["name"] for m in plan["end_to_end"]] == ["train_tokens_per_s", "train_peak_mem_gib", "setup_s"]
    cell = plan["cell"]
    assert (cell["batch"], cell["seq_len"], cell["chips"]) == (1, 4096, 1)
    assert set(cell["limits"]) == set(compare.NUMBERS) and 0 < cell["route_agreement_floor"] < 1


def test_the_configuration_holds_the_published_config():
    """Every top-level number of the published config.json is in the file
    under its key, as published unless ``reduced`` names the key (then its
    ``run`` value); the widths the model runs are the published ones."""
    pub, reduced = CONFIG["published"], CONFIG["reduced"]
    for key, value in pub.items():
        want = reduced[key]["run"] if key in reduced else value
        assert CONFIG[key] == want, key
        if key in reduced:
            assert reduced[key]["published"] == value, key
    assert set(reduced) == {"num_hidden_layers", "first_k_dense_replace", "n_routed_experts",
                            "num_nextn_predict_layers"}
    bench = registry.load_benchmark(ROOT)
    entry = next(c for c in bench["configs"] if c["name"] == "deepseek-v3")
    assert set(entry["reduced"]) == set(reduced) and not CONFIG["departs"]
    m = MODEL
    assert (m["d_model"], m["num_heads"], m["q_lora_rank"], m["kv_lora_rank"]) == (
        pub["hidden_size"], pub["num_attention_heads"], pub["q_lora_rank"], pub["kv_lora_rank"])
    assert (m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]) == (
        pub["qk_nope_head_dim"], pub["qk_rope_head_dim"], pub["v_head_dim"])
    assert (m["d_ff"], m["d_ff_expert"], m["num_experts"], m["top_k"]) == (
        pub["intermediate_size"], pub["moe_intermediate_size"], pub["n_routed_experts"], pub["num_experts_per_tok"])
    assert (m["router_groups"], m["router_groups_kept"], m["routed_scale"], m["num_shared_experts"]) == (
        pub["n_group"], pub["topk_group"], pub["routed_scaling_factor"], pub["n_shared_experts"])
    assert (m["vocab_size"], m["rms_norm_eps"], m["rope_base"]) == (
        pub["vocab_size"], pub["rms_norm_eps"], pub["rope_theta"])
    assert (m["num_layers"], m["dense_prefix_layers"], m["num_experts_held"]) == (
        CONFIG["num_hidden_layers"], CONFIG["first_k_dense_replace"], CONFIG["n_routed_experts"])


def test_layout_matches_the_ports_parameter_tree():
    """Every parameter of the layout at the port's path, shape and dtype,
    and no other leaf (fake tensors: nothing allocated)."""
    cfg = train_v3.port_config(CONFIG, MODEL)
    assert (cfg.use_mla, cfg.dense_prefix_mla, cfg.use_mtp, cfg.router_score, cfg.moe_impl) == (
        True, True, False, "sigmoid", "held")
    train.check_layout(cfg, weights_v3.param_layout(weights_v3.layout(MODEL)))


def test_layout_counts_the_published_parameters():
    """Per MLA: 7,168 x 1,536 + 1,536 + 1,536 x 128 x 192 + 7,168 x 512 +
    512 + 512 x 128 x (128 + 128) + 7,168 x 64 + 128 x 128 x 7,168 =
    187,107,328. The dense layer adds its MLP 3 x 7,168 x 18,432 =
    396,361,728 and two gains: 583,483,392. A MoE layer adds the router
    7,168 x 256 = 1,835,008, 8 experts of 3 x 7,168 x 2,048 = 44,040,192
    and one shared expert of as many, two gains: 585,318,400. Embedding and
    head 926,679,040 each, the final gain 7,168: 4,778,122,240 parameters,
    and the 4 biases of 256 beside them."""
    lay = weights_v3.layout(MODEL)
    play = weights_v3.param_layout(lay)
    assert weights.numel(play) == 2 * 926_679_040 + 583_483_392 + 4 * 585_318_400 + 7_168 == 4_778_122_240
    assert weights.numel(lay) - weights.numel(play) == 4 * 256
    assert len(play) == 1 + 14 + 4 * 18 + 2


def test_v3_model_flops_per_step():
    """Weights a token uses: MLA's projections 187,105,280 (187,107,328
    less the latent norms' 2,048 gains) a layer, 5 layers; the dense MLP
    396,361,728; a MoE layer's router 1,835,008, its shared expert
    44,040,192 and 8 x 8 / 256 of a routed expert's 44,040,192
    (11,010,048): 56,885,248, 4 layers; the head 926,679,040. Sum
    2,486,108,160; six FLOPs each a token over 4,096 tokens:
    61,098,993,319,936. Attention: 4,096 x 4,097 / 2 = 8,390,656 causal
    pairs, 128 heads, 5 layers, 6 x (192 + 128) FLOPs:
    10,310,038,913,024. Sum 71,409,032,232,960 (7.14e13)."""
    assert work_v3.weights_per_token(MODEL) == 2_486_108_160
    assert work_v3.model_flops_per_step(MODEL, 1, 4096) == 71_409_032_232_960


def test_flash_bounds_count_mlas_true_work():
    pairs = 128 * 4096 * 4097 // 2
    for which, per in (("fwd", 2 * 192 + 2 * 128), ("dq", 4 * 192 + 2 * 128), ("dkv", 4 * 192 + 4 * 128)):
        s, by = work_v3.flash_bound_s(which, MODEL, 1, 4096)
        assert by == "operations"
        assert s == pytest.approx(per * pairs / 989e12, rel=1e-12)
    # at D = Dqk = Dv the counts are work.py's 4·D, 6·D, 8·D
    m = dict(MODEL, qk_nope_head_dim=64, qk_rope_head_dim=64, v_head_dim=128, num_heads=32)
    for which in ("fwd", "dq", "dkv"):
        assert work_v3.flash_bound_s(which, m, 1, 4096)[0] == pytest.approx(
            work.flash_bound_s(which, 1, 32, 32, 4096, 128)[0], rel=1e-12)


@pytest.fixture
def stub_spans(monkeypatch):
    module = types.ModuleType("repro_torch.spans")
    module.summary = lambda: module.given
    monkeypatch.setitem(sys.modules, "repro_torch.spans", module)
    return lambda got: setattr(module, "given", got)


STEPS, TOKENS = 4, 4096


def _span_summary(spans, layers, seconds=0.01, **change):
    out = {"train.step": {"count": STEPS, "items": STEPS * TOKENS, "host_s": 1.0, "device_s": 1.0}}
    for name in spans:
        for span, n in ((name, STEPS * layers * 2), (name + ".bwd", STEPS * layers)):
            out[span] = {"count": n, "items": n * TOKENS, "host_s": seconds, "device_s": seconds}
    out[spans[0]].update(change)
    return out


def _run(trace=True, window=None):
    return {"model": MODEL, "cell": {"batch": 1, "seq_len": TOKENS}, "train": CONFIG["train"],
            "window": window, "trace": {"steps": STEPS, "ops": [], "window_s": 1.0} if trace else None}


@pytest.mark.parametrize("name, spans, layers", [("moe_ms.train_v3", ("moe.route", "moe.held", "moe.shared"), 4),
                                                ("mla_ms.train_v3", ("attn.mla",), 5)])
def test_span_readers(stub_spans, monkeypatch, name, spans, layers):
    read = _reader(name).read
    stub_spans(_span_summary(spans, layers))
    assert read(_run()) == pytest.approx(1e3 * 0.01 * 2 * len(spans) / STEPS, rel=1e-12)
    for change in ({"count": STEPS * layers}, {"items": None}, {"device_s": None}):
        stub_spans(_span_summary(spans, layers, **change))
        assert read(_run()) is None, change
    stub_spans(_span_summary(spans, layers))
    assert read(_run(trace=False)) is None
    stub_spans({})
    assert read(_run()) is None
    monkeypatch.delitem(sys.modules, "repro_torch.spans")
    assert read(_run()) is None


def test_the_loss_head_reader_reads_the_v3_record(stub_spans):
    """``loss_head_ms.train``, shared with deepseek-7b's cell, on this
    cell's record: ``moe_loss``'s head spans fire once a traced step and
    count the cell's tokens (tests/test_torch_deepseek_v3.py)."""
    read = _reader("loss_head_ms.train").read
    one = {"count": STEPS, "items": STEPS * TOKENS, "host_s": 0.01, "device_s": 0.01}
    stub_spans({"model.loss_head": one, "model.loss_head.bwd": one})
    assert read(_run()) == pytest.approx(1e3 * 0.02 / STEPS, rel=1e-12)
    stub_spans({"model.loss_head": one})
    assert read(_run()) is None


def test_mfu_and_flash_readers():
    mfu = _reader("mfu.train_v3").read
    assert mfu(_run(window={"steps": 10, "seconds": 2.5})) == pytest.approx(
        100 * 71_409_032_232_960 * 10 / (2.5 * 989e12))
    assert mfu(_run(window=None)) is None
    flash = _reader("flash_roofline_pct.train_v3")
    ops, t = [], 0
    for kernel, which in flash.KERNELS.items():
        ns = round(4e9 * work_v3.flash_bound_s(which, MODEL, 1, TOKENS)[0])
        ops.append((f"void (anonymous namespace)::{kernel}<256>(CUtensorMap_st)", t, t + ns))
        t += ns
    run = _run()
    run["trace"]["ops"] = ops + [("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", t, t + 10 ** 9)]
    assert flash.read(run) == pytest.approx(25.0, rel=1e-6)
    run["trace"]["ops"] = ops[-0:0]
    assert flash.read(run) is None
    assert flash.read(_run(trace=False)) is None


PROBE = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import perfbench.reference.deepseek_v3, perfbench.weights_v3, perfbench.work_v3, perfbench.compare
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_the_reference_and_its_helpers_load_nothing_of_the_program():
    done = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    loaded = set(json.loads(done.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, loaded
    for path in (HERE / "reference" / "deepseek_v3.py", HERE / "weights_v3.py", HERE / "work_v3.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "repro", "repro_torch"), (path.name, n)


# ---------------------------------------------------------------------------
# the check at small widths
# ---------------------------------------------------------------------------

SMALL = dict(num_layers=3, dense_prefix_layers=1, d_model=64, num_heads=4, q_lora_rank=32, kv_lora_rank=16,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, d_ff=96, d_ff_expert=32, num_experts=32,
             num_experts_held=8, first_expert_held=8, top_k=4, router_groups=4, router_groups_kept=2,
             vocab_size=256)
SHAPE = dict(batch=1, seq_len=128, steps_drawn=6)
SEED = 2 ** 31 + 11


def _small():
    plan = registry.plan(CELL, ROOT)
    return plan, dict(MODEL, **SMALL), dict(plan["cell"], **SHAPE)


def _mode(build=None):
    plan, model, cell = _small()
    return train_v3.run({"seed": SEED, "seconds": 0.1, "trace": 0, "cell": cell, "config": plan["config"],
                         "device": "cpu", "t_start": time.monotonic(), "log": lambda msg: None, "model": model,
                         "build_train_step": build})


@pytest.fixture(scope="module")
def sound():
    return _mode()["checks"]


@pytest.mark.parametrize("fault", list(faults.FAULTS))
def test_a_broken_step_is_not_correct_and_reads_far_from_a_sound_one(sound, fault):
    from repro_torch.launch.steps import build_train_step

    out = _mode(faults.FAULTS[fault](build_train_step))
    assert out["correct"] is False and out["failed"] == 0, out["checks"]
    broken = out["checks"]
    assert broken["grad_norm_gap"]["value"] / sound["grad_norm_gap"]["value"] > 10
    assert sound["route_agreement"]["value"] > 0.9


def test_the_references_half_batch_fault_moves_it():
    """The half-batch loss, like decoder.py's, changes what the float32
    reference reads (routed as the sound reference chose)."""
    plan, model, cell = _small()
    hp = plan["config"]["train"]
    pool = weights.batch_pool(SEED, cell["steps_drawn"], cell["batch"], cell["seq_len"], model["vocab_size"], "cpu")
    batches = [pool[i] for i in range(train.CHECK_STEPS)]
    ref = deepseek_v3.follow(model, hp, SEED, batches, "cpu")
    got = deepseek_v3.follow(model, hp, SEED, batches, "cpu", choices=ref["choices"], half_batch=True)
    numbers = compare.readings(got, ref)
    assert numbers["grad_norm_gap"] > 1e-2, numbers


@pytest.mark.parametrize("side", ["control", "route_no_bias"])
def test_the_control_and_the_routing_fault_are_not_correct(side):
    """In the program's place, routing on their own; judged against the
    float32 reference forced to their choices."""
    plan, model, cell = _small()
    hp = plan["config"]["train"]
    pool = weights.batch_pool(SEED, cell["steps_drawn"], cell["batch"], cell["seq_len"], model["vocab_size"], "cpu")
    batches = [pool[i] for i in range(train.CHECK_STEPS)]
    kw = {"precision": "fp8"} if side == "control" else {"route_fault": "no_bias"}
    got = deepseek_v3.follow(model, hp, SEED, batches, "cpu", **kw)
    ref = deepseek_v3.follow(model, hp, SEED, batches, "cpu", choices=got["choices"])
    names = ["/".join(map(str, p)) for p, _, _ in weights_v3.param_layout(weights_v3.layout(model))]
    correct, checks, _ = train_v3.judge(got, ref, cell, names)
    assert not correct, checks
    if side == "route_no_bias":  # the same experts forced: only the agreement tells
        assert checks["route_agreement"]["value"] < checks["route_agreement"]["limit"], checks
