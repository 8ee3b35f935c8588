"""The port's dry run (``repro_torch.launch.dryrun``, ``hlo_analysis``,
``roofline``, ``input_specs``, ``abstract_params``/``abstract_opt_state``,
``make_production_mesh``) against the reference's, on the CPU.

* ``configure`` and ``supports_mode`` agree for every arch x input shape;
* ``input_specs`` agrees in shapes and dtypes for every admitted arch x
  shape at full size (the reference's decode cache from ``jax.eval_shape``,
  its layouts mapped as ``cache_from_jax`` maps them; tokens int64 in the
  port), and ``abstract_params`` leaf for leaf (layouts mapped as
  ``params_from_jax`` maps them), ``abstract_opt_state`` in element counts
  by dtype;
* ``roofline_terms`` and ``collective_bytes`` equal the reference's on the
  same inputs (the reference's ``HW`` set to the port's in memory);
* the counter's unsharded FLOPs of SMOKE deepseek-7b's train and prefill
  steps lie within 2% of the reference's ``analyze_hlo`` count;
* at 8 fake ranks on a (2, 4) mesh (one subprocess), the counter counts
  exactly the per-device FLOPs and ring bytes of DTensor products and
  collectives, and ``lower_one`` runs SMOKE deepseek-7b train, olmoe-1b-7b
  prefill (a2a) and gemma2-2b decode with the reference's key set and
  per-device FLOPs within 10% of the reference's at 8 forced host devices
  (a second subprocess, started with the first);
* ``python -m repro_torch.launch.dryrun`` runs a SMOKE combo on the
  production mesh (a third);
* the sLSTM scan and the mLSTM chunks counted by their trip counts
  (:func:`repro_torch.launch.hlo_analysis.run_trips`) count what the full
  loops count: unsharded against real tensors run step by step under the
  counter, and on the (2, 4) fake mesh against the same trace with the
  trip count turned off;
* ``remat="dots"``: the losses and gradients of four families' SMOKE
  models against the reference's under the same policy, the outputs the policy keeps against
  ``jax.ad_checkpoint``'s saved residuals of one layer group (in the
  reference's subprocess), and the unsharded FLOPs under ``"full"`` and
  ``"dots"`` against ``analyze_hlo``;
* the hill-climb (``repro_torch.launch.hillclimb``): its ``VARIANTS``
  equal ``scripts/hillclimb.py``'s (read with ``ast``: importing the
  script sets ``XLA_FLAGS``), each variant of the (2, 4) combos within 10%
  of the reference's per-device FLOPs, and its command line (a fourth
  subprocess).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

import jax  # noqa: E402

# the reference's dry run forces 512 host devices through XLA_FLAGS when it
# is imported: start this process's backend first and restore the variable,
# so neither this process nor the subprocesses the other tests start see it
jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
import jax.numpy as jnp  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro.launch.hlo_analysis import HloCost as RefHloCost  # noqa: E402
from repro.launch.steps import abstract_opt_state as ref_abstract_opt_state  # noqa: E402
from repro.launch.steps import abstract_params as ref_abstract_params  # noqa: E402
from repro.models import init_cache as ref_init_cache  # noqa: E402
from repro.models import supports_mode as ref_supports_mode  # noqa: E402
from repro.models.model import _batch_struct as ref_batch_struct  # noqa: E402

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.hlo_analysis import HloCost  # noqa: E402
from repro_torch.launch.steps import abstract_opt_state, abstract_params  # noqa: E402
from repro_torch.models import config_from_jax, input_specs, supports_mode  # noqa: E402
from repro_torch.models.convert import cache_from_jax, params_from_jax  # noqa: E402

ARCHS = list_archs()
SHAPES = list(INPUT_SHAPES)


def _reference_variants() -> dict:
    """``VARIANTS`` of ``scripts/hillclimb.py``, read from its source."""
    with open(os.path.join(REPO, "scripts", "hillclimb.py")) as f:
        tree = ast.parse(f.read())
    return next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "VARIANTS")


REF_VARIANTS = _reference_variants()
# the (2, 4) combos (arch, shape, config replacements, hill-climb variant):
# one per step kind, a2a on the MoE prefill; the MoE decode with the einsum
# dispatch at a capacity of 91 slots (B = 128, top 2 of 4 experts), which
# neither mesh axis divides; the hill-climb's variants on the train combos
# whose heads divide the model axis
MESH_COMBOS = (("deepseek-7b", "train_4k", {}, None), ("olmoe-1b-7b", "prefill_32k", {}, None),
               ("gemma2-2b", "decode_32k", {}, None), ("olmoe-1b-7b", "decode_32k", {"capacity_factor": 1.3}, None),
               *(("deepseek-7b", "train_4k", {}, v)
                 for v in ("fsdp_only", "no_actseq", "fsdp_tp_noseq", "remat_dots", "blockq_1024")),
               *(("olmoe-1b-7b", "train_4k", {}, v) for v in ("moe_einsum", "cap_1_0", "fsdp_cap10")),
               ("deepseek-v3-671b", "train_4k", {}, "ep_model"))
# remat="dots": the models whose losses and gradients are held to the
# reference's (B = 2, S = 64), and the layer groups whose saved outputs are
DOTS_ARCHS = ("gemma2-2b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b")
RESIDUAL_ARCHS = ("gemma2-2b", "olmoe-1b-7b", "deepseek-7b")
DOTS_B, DOTS_S = 2, 64
# test_torch_train.py's gradient limits; the loss within the SSM models' rtol
# (test_torch_ssm_models.py)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)
LOSS_RTOL = 1e-5
# the trip-counted loops: xlstm-1.3b SMOKE cut to one group (an mLSTM and
# an sLSTM block) with chunks of 4 and the group checkpointed as at full
# size: 16 steps of the sLSTM scan and 4 mLSTM chunks
TRIP_ARCH, TRIP_CFG = "xlstm-1.3b", {"remat": "full", "num_layers": 2, "chunk_size": 4}
TRIP = {"train": InputShape("trip", 16, 2, "train"), "prefill": InputShape("trip", 16, 2, "prefill")}
MESH_FLOPS_RTOL = 0.10
HLO_FLOPS_RTOL = 0.02
SMALL = {"train": InputShape("small", 64, 8, "train"), "prefill": InputShape("small", 64, 8, "prefill")}

# ---------------------------------------------------------------------------
# subprocesses, started once at the top of the module and read at its end
# ---------------------------------------------------------------------------

PORT_RANKS = """
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map
import repro_torch.launch.dryrun as D
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.model import fake_mode

D.open_fake_group(8)
mesh = make_smoke_mesh((2, 4), device_type="cpu")
# lower_one on this (2, 4) mesh in place of the production one, as the
# reference's side below is patched, in memory only
D.open_fake_group = lambda world_size: None
D.make_production_mesh = lambda multi_pod=False, device_type=None: mesh
out = {}

def counted(fn):
    with fake_mode(), CostCounter() as c:
        fn()
    return {"flops": c.cost.flops, "records": c.records, "coll": c.cost.coll_bytes}

with fake_mode():
    x = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(1)])
    xk = distribute_tensor(torch.empty(64, 32), mesh, [Replicate(), Shard(1)])
    wk = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(0)])
    t = torch.empty(64, 32)
out["rows_cols"] = counted(lambda: x @ w)
out["contraction"] = counted(lambda: xk @ wk)
out["local_map"] = counted(lambda: local_map(
    lambda a, b: a @ b, out_placements=[Shard(0), Shard(1)],
    in_placements=([Shard(0), Replicate()], [Replicate(), Shard(1)]), device_mesh=mesh)(x, w))
out["all_gather"] = counted(lambda: x.redistribute(mesh, [Replicate(), Replicate()]))
out["all_reduce"] = counted(lambda: (xk @ wk).redistribute(mesh, [Replicate(), Replicate()]))
out["all_to_all"] = counted(lambda: funcol.all_to_all_single(t, None, None, group=(mesh, 1)))
out["c10d_all_reduce"] = counted(lambda: dist.all_reduce(t, group=mesh.get_group(1)))
out["lower_one"] = {}
from repro_torch.launch.hillclimb import run_variant
for arch, shape, over, variant in %r:
    if variant is None:
        r = D.lower_one(arch, shape, verbose=False, device="cpu", smoke=True, cfg_overrides=over)
    else:
        r = run_variant(arch, shape, variant, device="cpu", smoke=True)
    out["lower_one"][f"{arch}.{shape}.{variant}"] = {"keys": sorted(r), "status": r["status"], "n_chips": r["n_chips"],
                                                     "flops": r["roofline"]["hlo_flops_per_device"],
                                                     "coll_total": r["collectives"]["total"]}
# the trip-counted sLSTM and mLSTM loops against the full loops, on the mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.models import ssm
cfg = get_config(%r, smoke=True).replace(**%r)
out["trips"] = {}
for mode in ("prefill", "train"):
    shape = InputShape("trip", 16, 2, mode)
    calls = []
    by_trips = ssm._slstm_by_trips, ssm._mlstm_by_trips
    ssm._slstm_by_trips = lambda *a: calls.append("s") or by_trips[0](*a)
    ssm._mlstm_by_trips = lambda *a: calls.append("m") or by_trips[1](*a)
    trip, _, _ = D.count_step(cfg, shape, mesh, {"act_seq": "model"}, device="cpu")
    counters = ssm.trip_counters
    ssm.trip_counters = lambda *t: []
    full, _, _ = D.count_step(cfg, shape, mesh, {"act_seq": "model"}, device="cpu")
    ssm.trip_counters = counters
    ssm._slstm_by_trips, ssm._mlstm_by_trips = by_trips
    out["trips"][mode] = {"calls": calls, **{k: [c.cost.flops, c.cost.mem_bytes, c.cost.coll_total, len(c.records)]
                                             for k, c in (("trip", trip), ("full", full))}}
# a2a over a flattened ("data", "model") expert group (deepseek-v3's rule)
r = D.lower_one("deepseek-v3-671b", "train_4k", verbose=False, device="cpu", smoke=True,
                cfg_overrides={"num_experts": 8}, rules_overrides={"expert": ("data", "model")})
out["two_expert_axes"] = {"status": r["status"], "a2a": r["collectives"]["_counts"]["all-to-all"],
                          "records": [x for x in D.moe_dispatch._EP_GROUPS]}
print("RESULT" + json.dumps(out))
""" % (MESH_COMBOS, TRIP_ARCH, TRIP_CFG)

REF_RANKS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 " + os.environ.get("XLA_FLAGS", "")
import json
import jax
from jax.sharding import AxisType
jax.devices()
import repro.launch.dryrun as D
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch import sharding as shd
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.steps import abstract_opt_state, abstract_params, build_prefill_step, build_train_step
from repro.models.model import _batch_struct

# the reference's dry run at SMOKE size on a (2, 4) mesh of Auto axes (the
# mesh its make_production_mesh means to build), in memory only
D.get_config = lambda arch: get_config(arch, smoke=True)
D.make_production_mesh = lambda multi_pod=False: jax.make_mesh((2, 4), ("data", "model"),
                                                               axis_types=(AxisType.Auto,) * 2)
out = {"lower_one": {}, "unsharded": {}, "residuals": {}}
VARIANTS = %r
for arch, shape, over, variant in %r:
    rules = {}
    if variant is not None:
        over, rules = VARIANTS[variant]
    r = D.lower_one(arch, shape, False, verbose=False, cfg_overrides=dict(over), rules_overrides=dict(rules))
    out["lower_one"][f"{arch}.{shape}.{variant}"] = {"keys": sorted(r), "flops": r["roofline"]["hlo_flops_per_device"]}
shd.set_mesh(None)  # lower_one leaves its mesh active
for mode, remat in (("train", "none"), ("prefill", "none"), ("train", "full"), ("train", "dots")):
    cfg = get_config("deepseek-7b", smoke=True).replace(remat=remat)
    p = abstract_params(cfg)
    b = _batch_struct(cfg, 8, 64, mode)
    if mode == "train":
        step, _ = build_train_step(cfg)
        lowered = jax.jit(step).lower(p, abstract_opt_state(cfg, p), b)
    else:
        lowered = jax.jit(build_prefill_step(cfg)).lower(p, b)
    out["unsharded"][f"{mode}.{remat}"] = analyze_hlo(lowered.compile().as_text()).flops

# remat="dots": the residuals that one layer group keeps under
# checkpoint_dots_with_no_batch_dims
import numpy as np
import jax.numpy as jnp
from jax._src.ad_checkpoint import saved_residuals
from repro.models import init_params
from repro.models import dense as RD, moe as RM
from repro.models.layers import make_rope

for arch in %r:
    cfg = get_config(arch, smoke=True).replace(remat="dots")
    p = init_params(cfg, jax.random.PRNGKey(0))
    h = jnp.ones((%d, %d, cfg.d_model), cfg.cdtype())
    pos = jnp.arange(h.shape[1])
    rope = make_rope(pos, cfg.hd, cfg.rope_base)
    if cfg.num_experts:
        gp = jax.tree.map(lambda x: x[0], p["moe_layers"])
        body = lambda h, lp: RM.moe_layer_apply(cfg, lp, h, q_pos=pos, kv_pos=pos, rope=rope)[0]
    else:
        gp = jax.tree.map(lambda x: x[0], p["layers"])

        def body(h, gp):
            for sub, kind in enumerate(RD.attn_pattern(cfg)):
                h, _ = RD.layer_apply(cfg, jax.tree.map(lambda x: x[sub], gp), h, kind, rope, q_pos=pos, kv_pos=pos)
            return h
    res = saved_residuals(RD._maybe_remat(cfg, body), h, gp)
    out["residuals"][arch] = [int(np.prod(a.shape)) for a, src in res
                              if not src.startswith(("from the argument", "from a constant"))]
print("RESULT" + json.dumps(out))
""" % (REF_VARIANTS, MESH_COMBOS, RESIDUAL_ARCHS, DOTS_B, DOTS_S)


def _start(code=None, argv=None):
    env = {**os.environ, "PYTHONPATH": SRC}
    cmd = [sys.executable, "-c", code] if code is not None else [sys.executable, *argv]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def _result(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:{out[-3000:]}\nSTDERR:{err[-4000:]}"
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """The four subprocesses, started before the module's first test."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cli_out, climb_out = tmp / "gemma2-2b.decode_32k.pod.json", tmp / "deepseek-7b.train_4k.remat_dots.json"
    ps = {"port": _start(PORT_RANKS), "ref": _start(REF_RANKS),
          "cli": _start(argv=["-m", "repro_torch.launch.dryrun", "--arch", "gemma2-2b", "--shape", "decode_32k",
                              "--mesh", "pod", "--device", "cpu", "--smoke", "--out", str(cli_out)]),
          "climb": _start(argv=["-m", "repro_torch.launch.hillclimb", "--arch", "deepseek-7b", "--shape", "train_4k",
                                "--variant", "remat_dots", "--mesh", "pod", "--device", "cpu", "--smoke",
                                "--out", str(climb_out)]),
          "cli_out": cli_out, "climb_out": climb_out}
    yield ps
    for p in ps.values():
        if isinstance(p, subprocess.Popen) and p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def port_ranks(procs):
    return _result(procs["port"])


@pytest.fixture(scope="module")
def ref_ranks(procs):
    return _result(procs["ref"])


# ---------------------------------------------------------------------------
# layouts mapped on shapes, as the converters map arrays
# ---------------------------------------------------------------------------


def _flat(tree, path=""):
    """``{path: leaf}`` of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: v for key, x in tree.items() for k, v in _flat(x, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{path}/{i}").items()}
    return {path: tree}


def _port_dtype(dtype) -> torch.dtype:
    name = np.dtype(dtype).name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int64, "bool": torch.bool}[name]


class _Shape:
    """An array stand-in with a shape and no memory: ``np.asarray`` of it is
    a zero-stride view, which the converters reshape and index as views."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __array__(self, dtype=None, copy=None):
        return np.broadcast_to(np.zeros((), np.float32), self.shape)


def _port_layout(convert, cfg, tree):
    """``({path: shape}, dtypes)``: the port's layout that ``convert``
    (``params_from_jax``/``cache_from_jax``) makes of a reference tree of
    ``ShapeDtypeStruct``s, each leaf taken to a meta tensor of its shape
    (nothing is allocated at full size), and the reference's dtype names."""
    from repro_torch.models import convert as conv

    shapes = jax.tree.map(lambda s: _Shape(s.shape), tree)
    real = conv.tensor_from_numpy
    conv.tensor_from_numpy = lambda a, device="cuda": torch.empty(np.shape(a), device="meta")
    try:
        port = convert(cfg, shapes, device="cpu")
    finally:
        conv.tensor_from_numpy = real
    return _layout(port), sorted({np.dtype(x.dtype).name for x in jax.tree.leaves(tree)})


def _layout(tree) -> dict:
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


# ---------------------------------------------------------------------------
# the private torch modules the dry run needs
# ---------------------------------------------------------------------------


def test_private_torch_modules_import():
    """``FakeStore`` and ``FakeTensorMode`` live in private torch modules:
    a torch upgrade that moves them fails here first."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert callable(FakeStore) and callable(FakeTensorMode)


# ---------------------------------------------------------------------------
# configure, supports_mode, input_specs, abstract values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_configure_and_supports_mode_match_the_reference(arch, shape):
    ref_cfg, ref_rules = ref_dryrun.configure(arch, ref_configs.INPUT_SHAPES[shape])
    cfg, rules = dryrun.configure(arch, INPUT_SHAPES[shape])
    assert cfg == config_from_jax(ref_cfg)
    assert rules == ref_rules
    assert supports_mode(cfg, INPUT_SHAPES[shape]) == ref_supports_mode(ref_cfg, ref_configs.INPUT_SHAPES[shape])


ADMITTED = [(a, s) for a in ARCHS for s in SHAPES
            if supports_mode(dryrun.configure(a, INPUT_SHAPES[s])[0], INPUT_SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", ADMITTED)
def test_input_specs_match_the_reference_at_full_size(arch, shape):
    """Shapes and dtypes of every stand-in; the reference's decode cache
    from ``jax.eval_shape(init_cache)`` (its own ``input_specs`` builds the
    cache concretely), mapped as ``cache_from_jax`` maps it."""
    ref_cfg, _ = ref_dryrun.configure(arch, ref_configs.INPUT_SHAPES[shape])
    cfg, _ = dryrun.configure(arch, INPUT_SHAPES[shape])
    sh = INPUT_SHAPES[shape]
    got = input_specs(cfg, sh, device="cpu")
    B, S = sh.global_batch, sh.seq_len
    if sh.mode in ("train", "prefill"):
        want = ref_batch_struct(ref_cfg, B, S, sh.mode)
        assert set(got) == {"batch"}
        assert _layout(got["batch"]) == _layout(want)
        assert {k: v.dtype for k, v in got["batch"].items()} == {k: _port_dtype(v.dtype) for k, v in want.items()}
        return
    ref_cache = jax.eval_shape(lambda: ref_init_cache(ref_cfg, B, S))
    want_layout, ref_dtypes = _port_layout(cache_from_jax, cfg, ref_cache)
    assert set(got) == {"cache", "tokens", "pos"}
    assert _layout(got["cache"]) == want_layout
    assert sorted({str(v.dtype).split(".")[-1] for v in _flat(got["cache"]).values()}) == ref_dtypes
    assert tuple(got["tokens"].shape) == (B, 1) and got["tokens"].dtype == torch.int64  # reference: int32
    assert tuple(got["pos"].shape) == () and got["pos"].dtype == torch.int64
    assert all(v.device.type == "cpu" for v in _flat(got).values())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_opt_state_match_the_reference(arch):
    """Leaf for leaf (the reference's stacked layers mapped as
    ``params_from_jax`` maps them), the total element count exactly, and
    the optimizer state's element counts by dtype."""
    ref_cfg = ref_configs.get_config(arch)
    cfg = get_config(arch)
    ref_p = ref_abstract_params(ref_cfg)
    got = abstract_params(cfg, device="cpu")
    want_layout, _ = _port_layout(params_from_jax, cfg, ref_p)
    assert _layout(got) == want_layout
    want_dtypes = {np.dtype(x.dtype).name for x in jax.tree.leaves(ref_p)}
    assert {str(x.dtype).split(".")[-1] for x in _flat(got).values()} == want_dtypes
    assert sum(x.numel() for x in _flat(got).values()) == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref_p))

    def counts(leaves):
        out = {}
        for shape, dtype in leaves:
            out[dtype] = out.get(dtype, 0) + int(np.prod(shape))
        return out

    ref_o = ref_abstract_opt_state(ref_cfg, ref_p)
    o = abstract_opt_state(cfg, got)
    assert counts((x.shape, str(x.dtype).split(".")[-1]) for x in _flat(o).values()) == counts(
        (x.shape, np.dtype(x.dtype).name) for x in jax.tree.leaves(ref_o))


# one arch of each family's layout (deepseek-v3 and olmoe: with and without
# dense prefix layers)
LAYOUT_ARCHS = ("gemma2-2b", "deepseek-v3-671b", "olmoe-1b-7b", "xlstm-1.3b", "zamba2-2.7b", "hubert-xlarge",
                "paligemma-3b")


def test_layout_maps_follow_the_converters():
    """The shape-only maps above give what the converters give on real
    arrays (SMOKE size, every family's layout)."""
    for arch in LAYOUT_ARCHS:
        ref_cfg, cfg = ref_configs.get_config(arch, smoke=True), get_config(arch, smoke=True)
        ref_p = ref_abstract_params(ref_cfg)
        arrays = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), ref_p)
        assert _port_layout(params_from_jax, cfg, ref_p)[0] == _layout(params_from_jax(cfg, arrays, device="cpu"))
        if cfg.family != "encoder":
            ref_c = jax.eval_shape(lambda: ref_init_cache(ref_cfg, 2, 16))
            arrays = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), ref_c)
            assert _port_layout(cache_from_jax, cfg, ref_c)[0] == _layout(cache_from_jax(cfg, arrays, device="cpu"))


def test_decode_specs_allocate_nothing_at_long_length():
    """gemma2-2b's ``long_500k`` cache (and ``decode_32k``'s, 446.7 GB in the
    reference's layout) are fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensor

    for shape in ("decode_32k", "long_500k"):
        cfg, _ = dryrun.configure("gemma2-2b", INPUT_SHAPES[shape])
        leaves = _flat(input_specs(cfg, INPUT_SHAPES[shape], device="cpu")).values()
        assert all(isinstance(x, FakeTensor) for x in leaves)


# ---------------------------------------------------------------------------
# roofline arithmetic and collective bytes
# ---------------------------------------------------------------------------


def test_roofline_terms_match_the_reference(monkeypatch):
    monkeypatch.setattr(ref_roofline, "HW", dict(roofline.HW))
    cost = {"flops": 3.25e15, "bytes accessed": 7.5e12}
    coll = {"total": 4.2e11}
    assert roofline.roofline_terms(cost, coll) == ref_roofline.roofline_terms(cost, coll)
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 50e9}


HLO_LINES = """
  %all-gather.3 = f32[64,32]{1,0} all-gather(f32[32,32]{1,0} %p0), channel_id=1, replica_groups={{0,1},{2,3}}, dimensions={0}
  %all-reduce.7 = bf16[4096,256]{1,0} all-reduce(bf16[4096,256]{1,0} %p1), channel_id=2, replica_groups=[2,4]<=[8], to_apply=%add
  %reduce-scatter.1 = f32[16,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p2), channel_id=3, replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  %all-to-all.2 = f32[8,512]{1,0} all-to-all(f32[8,512]{1,0} %p3), channel_id=4, replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %collective-permute.5 = s32[1024]{0} collective-permute(s32[1024]{0} %p4), channel_id=5, source_target_pairs={{0,1},{1,0}}
  ROOT %all-reduce.9 = f32[128]{0} all-reduce(f32[128]{0} %p5), channel_id=6, replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
"""
# the same collectives as the counter records them: (op, local result bytes, group size)
RECORDS = [("all-gather", 64 * 32 * 4, 2), ("all-reduce", 4096 * 256 * 2, 4), ("reduce-scatter", 16 * 128 * 4, 4),
           ("all-to-all", 8 * 512 * 4, 4), ("collective-permute", 1024 * 4, 2), ("all-reduce", 128 * 4, 8)]


def test_collective_bytes_match_the_reference_parser():
    assert roofline.collective_bytes(RECORDS) == ref_roofline.collective_bytes(HLO_LINES)


def test_hlo_cost_adds_as_the_reference_does():
    a, b, ra, rb = HloCost(), HloCost(), RefHloCost(), RefHloCost()
    for c in (a, ra):
        c.flops, c.mem_bytes = 5.0, 7.0
        c.coll_bytes["all-gather"], c.coll_counts["all-gather"] = 3.0, 1
    for c in (b, rb):
        c.flops, c.mem_bytes = 1.5, 2.5
        c.coll_bytes["all-to-all"], c.coll_counts["all-to-all"] = 4.0, 2
    a.add(b, mult=3.0, mem=False)
    ra.add(rb, mult=3.0, mem=False)
    assert (a.flops, a.mem_bytes, a.coll_bytes, a.coll_counts, a.coll_total) == (
        ra.flops, ra.mem_bytes, ra.coll_bytes, ra.coll_counts, ra.coll_total)


def test_count_kernel_counts_into_every_active_counter():
    """A ctypes launch reaches no dispatcher: ``count_kernel`` adds its
    bytes and FLOPs to each active counter (nested ones too), times the
    trips being counted, under its own name in ``by_op``; with no counter
    active it does nothing."""
    from repro_torch.launch.hlo_analysis import CostCounter, count_kernel

    count_kernel("k", 18.0)
    with CostCounter() as outer:
        count_kernel("k", 18.0, 4.0)
        with CostCounter() as inner, inner.repeated(3):
            count_kernel("k", 10.0)
    assert (outer.cost.mem_bytes, outer.cost.flops, outer.by_op["k"]) == (28.0, 4.0, [2, 4.0, 28.0])
    assert (inner.cost.mem_bytes, inner.cost.flops, inner.by_op["k"]) == (30.0, 0.0, [3, 0.0, 30.0])


def test_flash_configs_are_refused():
    cfg, _ = dryrun.configure("gemma2-2b", SMALL["prefill"], smoke=True)
    with pytest.raises(ValueError, match="attn_impl='plain'"):
        dryrun.count_step(cfg.replace(attn_impl="flash"), SMALL["prefill"], device="cpu")


# ---------------------------------------------------------------------------
# remat="dots" against the reference's checkpoint_dots_with_no_batch_dims
# (in this process, while the subprocesses run)
# ---------------------------------------------------------------------------


def _reference_dots(arch):
    """``(cfg, params, batch, loss, grads)``: normal weights (standard
    deviation 0.05, drawn with numpy into the reference's tree, whose shapes
    ``jax.eval_shape`` gives without running its init) and tokens, carried
    over by ``params_from_jax``, and the reference's loss and gradients
    under ``remat="dots"``."""
    from repro.models import init_params as ref_init_params
    from repro.models import loss_fn as ref_loss_fn
    from repro_torch.models.convert import params_from_jax

    cfg_j = ref_configs.get_config(arch, smoke=True).replace(remat="dots")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 0.05).astype(x.dtype),
                        jax.eval_shape(lambda: ref_init_params(cfg_j, jax.random.PRNGKey(0))))
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (DOTS_B, DOTS_S + 1)).astype(np.int32)
    args = (jax.tree.map(jnp.asarray, tree), cfg_j, {"tokens": jnp.asarray(tokens)})
    # LLVM's optimisation level changes how fast the program runs, not what
    # it computes; level 0 halves the compile
    step = jax.jit(jax.value_and_grad(ref_loss_fn), static_argnums=1).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})
    loss, grads = step(args[0], args[2])
    cfg = config_from_jax(cfg_j)
    return (cfg, params_from_jax(cfg, tree, device="cpu"), {"tokens": torch.from_numpy(tokens).long()}, float(loss),
            params_from_jax(cfg, jax.tree.map(np.asarray, grads), device="cpu"))


@pytest.mark.parametrize("arch", DOTS_ARCHS)
def test_remat_dots_matches_the_reference(arch):
    """SMOKE models at B = 2, S = 64, float32, the same weights and tokens:
    the port's loss and gradients under ``remat="dots"`` against the
    reference's under ``checkpoint_dots_with_no_batch_dims`` (loss within
    rtol 1e-5, gradients within ``test_torch_train.py``'s limits)."""
    from repro_torch.launch import value_and_grad
    from repro_torch.optim import tree_leaves

    cfg, params, batch, want_loss, want = _reference_dots(arch)
    assert cfg.remat == "dots"
    loss, grads = value_and_grad(params, cfg, batch)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    got_l, want_l = tree_leaves(grads), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(params))
    for g, w in zip(got_l, want_l):
        torch.testing.assert_close(g, w, **TOL_GRAD)


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO count; the (2, 4) fake mesh
# ---------------------------------------------------------------------------


def _unsharded_flops(mode, remat="none") -> float:
    cfg, _ = dryrun.configure("deepseek-7b", SMALL[mode], smoke=True)
    counter, _, _ = dryrun.count_step(cfg.replace(remat=remat), SMALL[mode], device="cpu")
    return counter.cost.flops


@pytest.mark.parametrize("mode,remat", [("train", "none"), ("prefill", "none"), ("train", "full"), ("train", "dots")],
                         ids=["train", "prefill", "train-full", "train-dots"])
def test_unsharded_flops_match_the_reference_hlo(mode, remat, ref_ranks):
    """SMOKE deepseek-7b, B = 8, S = 64, no mesh: the counter's FLOPs
    against ``analyze_hlo`` of the reference's compiled step, without remat
    and under ``remat="full"`` and ``"dots"`` (the recomputed products
    counted as the reference's HLO counts them); ``"dots"`` counts fewer
    than ``"full"``: it recomputes no product without batch dims."""
    got = _unsharded_flops(mode, remat)
    want = ref_ranks["unsharded"][f"{mode}.{remat}"]
    print(f"deepseek-7b SMOKE {mode} remat={remat}: port {got:.6e} reference {want:.6e} ({got / want - 1:+.4%})")
    assert abs(got / want - 1) <= HLO_FLOPS_RTOL
    if remat == "dots":
        assert _unsharded_flops(mode) < got < _unsharded_flops(mode, "full")


def test_counter_counts_per_device_products_exactly(port_ranks):
    """x (64, 32) @ w (32, 16) on (data=2, model=4): rows on data and
    columns on model, 2*M*K*N / 8; the contraction split on model, / 4; the
    same product in a ``local_map`` body, / 8."""
    full = 2 * 64 * 32 * 16
    assert port_ranks["rows_cols"]["flops"] == full / 8
    assert port_ranks["contraction"]["flops"] == full / 4
    assert port_ranks["local_map"]["flops"] == full / 8


def test_counter_counts_ring_bytes_of_collectives(port_ranks):
    """An all-gather of x's rows over data (n = 2), the all-reduce of the
    contraction's partial sums over model (n = 4), an all-to-all over model
    (n = 4), and ``dist.all_reduce`` (the c10d op MoE and Adafactor issue)."""
    ag, ar, a2a, c10d = (port_ranks[k] for k in ("all_gather", "all_reduce", "all_to_all", "c10d_all_reduce"))
    assert ag["records"] == [["all-gather", 64 * 32 * 4, 2]] and ag["coll"]["all-gather"] == 64 * 32 * 4 / 2
    assert ar["records"] == [["all-reduce", 64 * 16 * 4, 4]] and ar["coll"]["all-reduce"] == 2 * 64 * 16 * 4 * 3 / 4
    assert a2a["records"] == [["all-to-all", 64 * 32 * 4, 4]] and a2a["coll"]["all-to-all"] == 64 * 32 * 4 * 3 / 4
    assert c10d["records"] == [["all-reduce", 64 * 32 * 4, 4]]


@pytest.mark.parametrize("arch,shape,over,variant", MESH_COMBOS,
                         ids=[f"{a}-{s}" + (f"-{v}" if v else "") for a, s, _, v in MESH_COMBOS])
def test_lower_one_on_the_2x4_mesh_matches_the_reference(arch, shape, over, variant, port_ranks, ref_ranks):
    """Per-device FLOPs within 10% of the reference's; a hill-climb variant
    through ``run_variant`` on the port's side and the reference's own
    ``VARIANTS`` entry on its side (the einsum MoE dispatch when training:
    each rank gathers and scatters its own tokens, 1.997x the reference's
    before it did)."""
    key = f"{arch}.{shape}.{variant}"
    got, want = port_ranks["lower_one"][key], ref_ranks["lower_one"][key]
    assert got["status"] == "ok" and got["n_chips"] == 8
    assert got["keys"] == want["keys"] + (["variant"] if variant else [])
    assert got["coll_total"] > 0
    print(f"{arch} {shape} {variant or ''} SMOKE on (2, 4): per-device FLOPs port {got['flops']:.6e} "
          f"reference {want['flops']:.6e} (ratio {got['flops'] / want['flops']:.4f})")
    assert abs(got["flops"] / want["flops"] - 1) <= MESH_FLOPS_RTOL


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_trip_counted_loops_count_what_the_full_loops_count(mode):
    """xlstm-1.3b SMOKE with its groups checkpointed (the recompute inside
    the backward is counted by trips too), unsharded: the fake trace, whose
    sLSTM scan and mLSTM chunk loop run their first and last trips and one
    trip for all the others, against real tensors run step by step under
    the counter. FLOPs, bytes and collective bytes are equal: the trips
    between the first and the last run the same ops, the autograd engine's
    sums of the gradients of what every trip reads are counted as adds, and
    the first trip (whose state needs no gradient) and the last (which hands
    no gradient on) run as the loop runs them."""
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.launch.steps import build_prefill_step, build_train_step
    from repro_torch.models import init_params, make_dummy_batch, ssm

    cfg = get_config(TRIP_ARCH, smoke=True).replace(**TRIP_CFG)
    shape = TRIP[mode]
    calls = []
    by_trips = ssm._slstm_by_trips, ssm._mlstm_by_trips
    try:
        ssm._slstm_by_trips = lambda *a: calls.append("s") or by_trips[0](*a)
        ssm._mlstm_by_trips = lambda *a: calls.append("m") or by_trips[1](*a)
        fake, _, _ = dryrun.count_step(cfg, shape, device="cpu")
        n_fake = len(calls)
        params = init_params(cfg, 0, device="cpu")
        batch = make_dummy_batch(cfg, shape.global_batch, shape.seq_len, mode, np.random.default_rng(0), device="cpu")
        if mode == "train":
            step, opt = build_train_step(cfg)
            args = (params, opt.init(params), batch)
        else:
            step, args = build_prefill_step(cfg), (params, batch)
        with CostCounter() as real:
            step(*args)
    finally:
        ssm._slstm_by_trips, ssm._mlstm_by_trips = by_trips
    groups = cfg.num_layers // cfg.slstm_every
    runs = 2 if mode == "train" else 1  # forward, and the groups' recompute
    assert calls.count("s") == groups * runs and calls.count("m") == groups * (cfg.slstm_every - 1) * runs
    assert n_fake == len(calls)  # the real tensors ran every trip
    assert real.cost.flops == fake.cost.flops > 0
    assert real.cost.mem_bytes == fake.cost.mem_bytes
    assert real.cost.coll_total == fake.cost.coll_total == 0


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_trip_counted_loops_on_the_2x4_mesh(mode, port_ranks):
    """The same step on the (2, 4) fake mesh (``act_seq`` on "model", the
    cells on local shards): the trip-counted trace against the same trace
    with the trip count turned off (every trip run on the fake shards):
    FLOPs, bytes, collective bytes and collectives equal."""
    got = port_ranks["trips"][mode]
    assert "s" in got["calls"] and "m" in got["calls"]
    assert got["trip"] == got["full"] and got["trip"][0] > 0 and got["trip"][2] > 0


def test_lower_one_flattens_two_expert_axes_before_the_trace(port_ranks):
    """SMOKE deepseek-v3 (8 experts) with experts over ("data", "model"):
    the flattened expert group is made outside the fake mode (inside it,
    the new mesh's coordinates would be fake tensors), and the a2a step
    traces with its all-to-alls."""
    got = port_ranks["two_expert_axes"]
    assert got["status"] == "ok" and got["a2a"] > 0 and len(got["records"]) == 1


def test_the_command_line_runs_on_the_production_mesh(procs):
    out, err = procs["cli"].communicate(timeout=300)
    assert procs["cli"].returncode == 0, err[-3000:]
    r = json.loads(procs["cli_out"].read_text())
    assert r["status"] == "ok" and r["n_chips"] == 256 and r["mesh"] == "16x16"
    assert r["compile_s"] == 0.0 and r["memory"]["temp_bytes"] is None and r["memory"]["peak_bytes"] is None
    assert r["roofline"]["hlo_flops_per_device"] == r["roofline_static"]["hlo_flops_per_device"] > 0


def test_the_hillclimb_variants_equal_the_reference():
    from repro_torch.launch.hillclimb import VARIANTS

    assert VARIANTS == REF_VARIANTS and list(VARIANTS) == list(REF_VARIANTS)


def test_the_hillclimb_command_line_writes_the_reference_keys(procs, ref_ranks):
    out, err = procs["climb"].communicate(timeout=300)
    assert procs["climb"].returncode == 0, err[-3000:]
    r = json.loads(procs["climb_out"].read_text())
    assert r["status"] == "ok" and r["variant"] == "remat_dots" and r["mesh"] == "16x16"
    assert sorted(r) == sorted(ref_ranks["lower_one"]["deepseek-7b.train_4k.None"]["keys"] + ["variant"])
    last = out.strip().splitlines()[-1]
    assert last.startswith("deepseek-7b train_4k [remat_dots]: compute=") and "dominant=" in last


# ---------------------------------------------------------------------------
# remat="dots" against the reference's checkpoint_dots_with_no_batch_dims
# ---------------------------------------------------------------------------


def _saved_by_dots(arch) -> list:
    """The element counts of the outputs that ``remat="dots"`` keeps in one
    layer group of ``arch`` SMOKE (B = 2, S = 64): the products its policy
    marks ``MUST_SAVE`` in the checkpoint's forward pass."""
    from repro_torch.models import dense, init_params, moe

    cfg = get_config(arch, smoke=True).replace(remat="dots")
    params = init_params(cfg, 0, device="cpu")
    h = torch.ones(DOTS_B, DOTS_S, cfg.d_model, requires_grad=True)
    pos = torch.arange(DOTS_S)
    rope = dense.make_rope(pos, cfg.hd, cfg.rope_base)
    shapes, policy = [], dense._save_dots

    def recording(ctx, func, *args, **kwargs):
        verdict = policy(ctx, func, *args, **kwargs)
        if verdict == dense.CheckpointPolicy.MUST_SAVE:
            a, b = args[-2:]  # mm(a, b), addmm(bias, a, b), bmm(a, b)
            shapes.append(int(np.prod(a.shape[:-1])) * b.shape[-1])
        return verdict

    dense._save_dots = recording
    try:
        if cfg.num_experts:
            body = dense._maybe_remat(cfg, lambda hh, lp: moe.moe_layer_apply(cfg, lp, hh, q_pos=pos, kv_pos=pos,
                                                                              rope=rope)[0])
            out = body(h, params["moe_layers"][0])
        else:
            out, _ = dense.stack_forward(cfg, params["layers"][:len(dense.attn_pattern(cfg))], h)
        out.sum().backward()
    finally:
        dense._save_dots = policy
    return shapes


@pytest.mark.parametrize("arch", RESIDUAL_ARCHS)
def test_remat_dots_saves_the_reference_dot_residuals(arch, ref_ranks):
    """The outputs kept by ``remat="dots"`` in one layer group, as a
    multiset of element counts, against the residuals that
    ``jax.ad_checkpoint``'s ``saved_residuals`` reports for the reference's
    group under ``checkpoint_dots_with_no_batch_dims`` (its arguments and
    constants left out): gemma2-2b's 14 products (q, k, v, the output
    projection and the MLP's three, two layers), olmoe-1b-7b's 7 (attention's
    four, the router, the dense dispatch's two products of the tokens with
    the stacked experts; the experts' down projection and the combine are
    batched over the experts and the tokens). deepseek-7b keeps one more
    than the reference: its layer's last product, the MLP's down projection,
    whose output only joins the residual, so the backward pass never reads
    it and JAX's partial evaluation drops it; torch's selective checkpoint
    keeps every output its policy saves (ROADMAP.md, Queue 3, known
    divergences)."""
    got, want = sorted(_saved_by_dots(arch)), list(ref_ranks["residuals"][arch])
    if arch == "deepseek-7b":
        want.append(DOTS_B * DOTS_S * get_config(arch, smoke=True).d_model)
    print(f"{arch}: port keeps {got}")
    assert got == sorted(want) and len(got) >= 7
