"""The benchmark's frozen work counts and its parameter layout, on the CPU."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from perfbench import weights, work

CONFIGS = Path(__file__).resolve().parent / "configs"
METRICS = Path(__file__).resolve().parent / "metrics"


def _model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_deepseek_7b_model_flops_per_step():
    """deepseek-7b cut to 16 layers, 1 x 4,096 tokens.

    Weights a token uses: per layer the four 4,096 x 4,096 attention
    projections (67,108,864) and the three 4,096 x 11,008 MLP matrices
    (135,266,304), 202,375,168; times 16 is 3,238,002,688; the head
    4,096 x 102,400 adds 419,430,400: 3,657,433,088. Six FLOPs each a
    token: 6 x 3,657,433,088 x 4,096 = 89,885,075,570,688.
    Causal pairs 4,096 x 4,097 / 2 = 8,390,656 per head; x 32 heads x 16
    layers x 12 x 128 = 6,598,680,379,392. Sum: 96,483,755,950,080 (9.65e13).
    """
    m = _model("deepseek-7b")
    assert work.weights_per_token(m) == 3_657_433_088
    assert work.model_flops_per_step(m, 1, 4096) == 96_483_755_950_080


def test_olmoe_1b_7b_model_flops_per_step():
    """olmoe-1b-7b cut to 8 layers, 1 x 4,096 tokens.

    Weights a token uses: per layer the four 2,048 x 2,048 attention
    projections (16,777,216), the router 2,048 x 64 (131,072) and the 8
    experts it is routed to, each three 2,048 x 1,024 matrices (50,331,648):
    67,239,936; times 8 is 537,919,488; the head 2,048 x 50,304 adds
    103,022,592: 640,942,080. 6 x 640,942,080 x 4,096 = 15,751,792,558,080.
    Causal pairs 8,390,656 per head x 16 heads x 8 layers x 12 x 128 =
    1,649,670,094,848. Sum: 17,401,462,652,928 (1.74e13).
    """
    m = _model("olmoe-1b-7b")
    assert work.weights_per_token(m) == 640_942_080
    assert work.model_flops_per_step(m, 1, 4096) == 17_401_462_652_928


@pytest.mark.parametrize("name, params, leaves", [("deepseek-7b", 4_076_998_656, 147),
                                                  ("olmoe-1b-7b", 3_562_571_776, 83)])
def test_layout_counts_the_published_parameters(name, params, leaves):
    lay = weights.layout(_model(name))
    assert weights.numel(lay) == params
    assert len(lay) == leaves


@pytest.mark.parametrize("name", ["deepseek-7b", "olmoe-1b-7b"])
def test_layout_matches_the_ports_parameter_tree(name):
    """Every leaf of the benchmark's layout at the port's path, shape and
    dtype, and no other leaf (fake tensors: nothing allocated)."""
    from perfbench.modes.train import check_layout, port_config

    config = json.loads((CONFIGS / f"{name}.json").read_text())
    check_layout(port_config(config, config["model"]), weights.layout(config["model"]))


def test_flash_bounds_follow_the_launch_conventions():
    """One causal launch at B = 1, H = 32, S = 4,096, D = 128: 4·D, 6·D and
    8·D FLOPs per pair over 989e12 FLOP/s, each bound by its operations."""
    pairs = 32 * 4096 * 4097 // 2
    assert work.attn_pairs(1, 32, 4096) == pairs
    for which, per in (("fwd", 4), ("dq", 6), ("dkv", 8)):
        s, by = work.flash_bound_s(which, 1, 32, 32, 4096, 128)
        assert by == "operations"
        assert s == pytest.approx(per * 128 * pairs / 989e12, rel=1e-12)
    # a short sequence is bound by its bytes: q, k, v, o at 2 bytes and lse at 4
    s, by = work.flash_bound_s("fwd", 1, 1, 1, 16, 128)
    assert by == "bytes"
    assert s == pytest.approx((2 * 4 * 16 * 128 + 4 * 16) / 3.35e12)


def test_weights_are_made_from_the_seed():
    m = dict(_model("olmoe-1b-7b"), num_layers=1, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
             num_experts=4, top_k=2, d_ff_expert=8, vocab_size=64)
    lay = weights.layout(m)
    a, b = (weights.make_flat(lay, 2 ** 31 + 7, "cpu", torch.bfloat16) for _ in range(2))
    c = weights.make_flat(lay, 2 ** 31 + 8, "cpu", torch.bfloat16)
    assert bool((a == b).all()) and not bool((a == c).all())
    leaves = dict(zip(("/".join(map(str, p)) for p, _, _ in lay), weights.views(lay, a)))
    assert not bool(leaves["moe_layers/0/ln1"].any())
    assert float(leaves["lm_head"].float().abs().max()) <= 2.0 / 32 ** 0.5
    t = weights.batch_pool(5, 4, 2, 8, 64, "cpu")
    assert t.shape == (4, 2, 9) and int(t.min()) >= 0 and int(t.max()) < 64
    assert bool((t == weights.batch_pool(5, 4, 2, 8, 64, "cpu")).all())



def _reader(name):
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name, kind", [
    ("void (anonymous namespace)::flash_fwd_tc_kernel<128>(CUtensorMap_st, CUtensorMap_st, float*)", "fwd"),
    ("void (anonymous namespace)::flash_dq_tc_kernel<128>(CUtensorMap_st, CUtensorMap_st, float const*)", "dq"),
    ("void (anonymous namespace)::flash_dkv_tc_kernel<128>(CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*)", "dkv"),
    ("void (anonymous namespace)::flash_fwd_kernel<128>(float const*, float const*, float*)", None),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<128>(float const*, float*)", None),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<128>(float const*, float*)", None),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 128, 64, 4, false, false, "
     "cutlass::bfloat16_t> >(Flash_fwd_params)", None),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", None),
])
def test_flash_roofline_selects_the_ports_kernels_by_name(name, kind):
    assert _reader("flash_roofline_pct.train").launch_kind(name) == kind


def test_flash_roofline_is_bound_over_device_time():
    """One launch of each of the port's kernels, each taking twice its
    least time, and a library kernel that is not counted: 50%."""
    reader = _reader("flash_roofline_pct.train")
    m, cell = _model("deepseek-7b"), {"batch": 1, "seq_len": 4096}
    ops, t = [], 0
    for name, which in reader.KERNELS.items():
        ns = round(2e9 * work.flash_bound_s(which, 1, 32, 32, 4096, 128)[0])
        ops.append((f"void (anonymous namespace)::{name}<128>(CUtensorMap_st)", t, t + ns))
        t += ns
    ops.append(("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128> >(Flash_fwd_params)", t, t + 10**9))
    got = reader.read({"model": m, "cell": cell, "trace": {"ops": ops}})
    assert got == pytest.approx(50.0, rel=1e-6)
    assert reader.read({"model": m, "cell": cell, "trace": {"ops": ops[-1:]}}) is None
