"""The port's sharding rules and spec functions against the JAX package's,
on the reference's 16 x 16 stand-in mesh and small ones, with no process
group: ``infer_pspec`` (the reference's three rule cases and every leaf of
every SMOKE arch), ``batch_pspecs``, ``cache_pspecs``, ``opt_state_pspecs``,
``spec_to_placements`` and ``shard``.

A port spec is a tuple; the reference's is a ``PartitionSpec``, compared as
``tuple(P)``. The port's parameter paths index a list of layers
(``layers/3/attn/wq``); the reference's stacked leaf (``layers/attn/wq``)
carries the stacked axes in front, whose spec entries are ``None``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.models.model import init_cache, init_params, layer_stacks
from repro_torch.models.moe_dispatch import _ep_ranks

# the reference's stand-in mesh (tests/test_sharding_and_hlo_analysis.py)
class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class SmallMesh:
    axis_names = ("data", "model")
    shape = {"data": 2, "model": 4}


class PodMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}

# the reference stores these lists of layers under other names
REF_LIST_NAMES = {"mlstm": "groups/mlstm", "slstm": "groups/slstm", "mamba": "mamba_groups"}


@pytest.fixture
def meshes():
    """``use(mesh, rules)`` installs a mesh in both packages; both are reset
    after the test."""

    def use(mesh, rules=None):
        jshd.set_mesh(mesh, rules)
        shd.set_mesh(mesh, rules)

    yield use
    jshd.set_mesh(None)
    shd.set_mesh(None)


def _spec(p):
    return tuple(p)


def _ref_path(path: str) -> str:
    """The reference's stacked path of a port path."""
    parts = path.split("/")
    if len(parts) > 1 and parts[1].isdigit():
        parts = [REF_LIST_NAMES.get(parts[0], parts[0])] + parts[2:]
    return "/".join(parts)


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, x in tree.items() for k, v in _flat_specs(x, f"{prefix}/{key}" if prefix else key).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _flat_specs(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p, simple=True, separator="/"): x for p, x in leaves}


def _ref_params(arch):
    cfg = jax_get_config(arch, smoke=True)
    return cfg, jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))


def test_param_rules_basic(meshes):
    meshes(FakeMesh())
    cases = [
        ("layers/attn/wq", (30, 4096, 32, 128), (None, "data", "model", None)),
        ("layers/attn/wo", (30, 32, 128, 4096), (None, "model", None, "data")),
        ("layers/mlp/w_in", (30, 4096, 11008), (None, "data", "model")),
        ("emb", (50304, 2048), ("model", "data")),
        ("ln_f", (2048,), ()),
    ]
    for path, shape, want in cases:
        assert shd.infer_pspec(path, shape) == want == _spec(jshd.infer_pspec(path, shape))
    # the port's per-layer path: the same rule without the stacked axis
    assert shd.infer_pspec("layers/3/attn/wq", (4096, 32, 128)) == ("data", "model", None)


def test_param_rules_divisibility_fallback(meshes):
    meshes(FakeMesh())
    cases = [
        ("layers/attn/wk", (52, 6144, 1, 128), (None, "data", None, None)),  # MQA: one KV head
        ("layers/attn/wk", (32, 4096, 8, 128), (None, "data", None, None)),  # 8 KV heads on 16
        ("layers/mlp/w_in", (2, 100, 48), (None, None, "model")),  # d = 100 on 16
    ]
    for path, shape, want in cases:
        assert shd.infer_pspec(path, shape) == want == _spec(jshd.infer_pspec(path, shape))


def test_expert_rules_no_axis_duplication(meshes):
    meshes(FakeMesh())
    spec = shd.infer_pspec("moe/experts/w_gate", (58, 256, 7168, 2048))
    assert spec == _spec(jshd.infer_pspec("moe/experts/w_gate", (58, 256, 7168, 2048)))
    flat = [a for part in spec if part is not None for a in ((part,) if isinstance(part, str) else part)]
    assert len(flat) == len(set(flat)), f"duplicated mesh axis in {spec}"
    shd.spec_to_placements(spec, FakeMesh())  # no axis used twice


@pytest.mark.parametrize("arch", jax_list_archs())
def test_infer_pspec_on_every_smoke_leaf(meshes, arch):
    """Every leaf of the port's tree against the reference's stacked leaf:
    the reference's spec is the stacked axes' ``None`` and then the port's
    (or ``()`` for both)."""
    meshes(SmallMesh())
    cfg_j, tree = _ref_params(arch)
    want = _ref_flat(jshd.param_pspecs(tree))
    shapes = {jax.tree_util.keystr(p, simple=True, separator="/"): x.shape
              for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = _flat_specs(shd.param_pspecs(init_params(get_config(arch, smoke=True), 0, device="cpu")))
    seen = set()
    for path, spec in got.items():
        ref = _ref_path(path)
        seen.add(ref)
        w = _spec(want[ref])
        lead = len(shapes[ref]) - (len(spec) if spec else len(shapes[ref]))
        assert w == ((None,) * lead + spec if spec else ()), (path, spec, w)
    assert seen == set(want)


def test_pod_rule_and_mesh_context(meshes):
    meshes(PodMesh())
    assert shd.rules()["batch"] == ("pod", "data") == tuple(jshd.rules()["batch"])
    assert shd.logical_to_mesh("batch", None, "tensor") == _spec(jshd.logical_to_mesh("batch", None, "tensor"))
    assert shd.axis_size("batch") == jshd.axis_size("batch") == 32
    assert shd.spec_to_placements(shd.logical_to_mesh("batch", "tensor"), PodMesh()) == [Shard(0), Shard(0), Shard(1)]
    with shd.mesh_context(SmallMesh(), {"act_seq": "model"}):
        assert shd.current_mesh().shape["model"] == 4 and shd.rules()["act_seq"] == "model"
        assert shd.rules()["batch"] == ("data",)
    assert isinstance(shd.current_mesh(), PodMesh) and shd.rules()["act_seq"] is None


@pytest.mark.parametrize("layers", [2, 8])
def test_batch_and_cache_pspecs_match_the_reference(meshes, layers):
    """gemma2-2b SMOKE, B = 8, S = 64 on 2 x 4: the batch on "data"; the
    cache's specs past its layer axis are the reference's past its
    ``(n_groups, period)`` axes, and the layer axis takes none, also when
    the layer count equals B (8 layers; the reference puts "model" on its
    4 groups there)."""
    meshes(SmallMesh())
    cfg_j = jax_get_config("gemma2-2b", smoke=True).replace(num_layers=layers)
    cfg = get_config("gemma2-2b", smoke=True).replace(num_layers=layers)
    B, S = 8, 64
    tok_j, tok = jax.ShapeDtypeStruct((B, S), np.int32), torch.zeros((B, S), dtype=torch.long)
    assert steps.batch_pspecs(cfg, {"tokens": tok}, B) == {"tokens": ("data", None)}
    assert steps.batch_pspecs(cfg, {"tokens": tok}, B)["tokens"] == _spec(jsteps.batch_pspecs(cfg_j, {"tokens": tok_j}, B)["tokens"])
    assert steps.batch_pspecs(cfg, tok[:3], 3) == (None, None)  # 3 does not divide by "data"
    want = jsteps.cache_pspecs(cfg_j, jax.eval_shape(lambda: jax_init_cache(cfg_j, B, S)), B, S)
    got = steps.cache_pspecs(cfg, init_cache(cfg, B, S, device="cpu"), B, S)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g == (None,) + _spec(w)[2:] == (None, "data", None, None, None)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adafactor"])
def test_opt_state_pspecs_match_the_reference(meshes, name):
    """The optimizer state's specs, leaf by leaf. Adafactor's ``vr``/``vc``
    live on the stacked leaves in both packages (deepseek-v3-671b SMOKE,
    the reference's Adafactor model; the others on gemma2-2b SMOKE)."""
    meshes(SmallMesh())
    arch = "deepseek-v3-671b" if name == "adafactor" else "gemma2-2b"
    cfg_j, tree = _ref_params(arch)
    cfg_j = cfg_j.replace(optimizer=name)
    cfg = get_config(arch, smoke=True).replace(optimizer=name)
    pspecs = shd.param_pspecs(init_params(cfg, 0, device="cpu"))
    got = steps.opt_state_pspecs(cfg, pspecs)
    want = jsteps.opt_state_pspecs(cfg_j, jshd.param_pspecs(tree))
    if name == "sgd":
        assert got == () == want
        return
    if name == "momentum":
        got_parts, want_parts = {"m": got}, {"m": want}
    else:
        assert got.step == () == _spec(want.step)
        fields = ("mu", "nu") if name == "adamw" else ("vr", "vc")
        got_parts = {f: getattr(got, f) for f in fields}
        want_parts = {f: getattr(want, f) for f in fields}
    for f in got_parts:
        w = {k: _spec(v) for k, v in _ref_flat(want_parts[f]).items()}
        if name == "adafactor":  # both on the stacked tree: the same paths and specs
            assert _flat_specs(got_parts[f]) == w
            continue
        g = {}
        for path, spec in _flat_specs(got_parts[f]).items():
            g.setdefault(_ref_path(path), set()).add(spec)
        assert set(g) == set(w)
        for ref, specs in g.items():
            (spec,) = specs
            assert w[ref][-len(spec):] == spec if spec else w[ref] == ()
    if name == "adafactor":
        assert set(layer_stacks(cfg)) == {"moe_layers", "dense_layers"}


def test_train_shardings_are_placements(meshes):
    meshes(SmallMesh(), {"act_seq": "model"})
    cfg = get_config("gemma2-2b", smoke=True)
    params = init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((8, 33), dtype=torch.long)}
    p_pl, o_pl, b_pl = steps.train_shardings(cfg, params, None, batch, 8)
    assert p_pl["emb"] == [Shard(1), Shard(0)]  # (V, d): V on "model", d on "data"
    assert p_pl["layers"][0]["attn"]["wk"] == [Shard(0), Replicate()]  # 2 KV heads on 4: replicated
    assert o_pl.mu == p_pl and o_pl.nu == p_pl and o_pl.step == [Replicate(), Replicate()]
    assert b_pl == {"tokens": [Shard(0), Replicate()]}
    assert steps.train_shardings(cfg.replace(optimizer="sgd"), params, None, batch, 8)[1] == ()


def test_spec_to_placements():
    mesh = SmallMesh()
    assert shd.spec_to_placements((None, "model", "data"), mesh) == [Shard(2), Shard(1)]
    assert shd.spec_to_placements((("data", "model"), None), mesh) == [Shard(0), Shard(0)]
    assert shd.spec_to_placements((), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="twice"):
        shd.spec_to_placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.spec_to_placements((("data", "model"), "model"), mesh)
    with pytest.raises(ValueError, match="order"):
        shd.spec_to_placements((("model", "data"),), mesh)
    with pytest.raises(ValueError, match="no axis"):
        shd.spec_to_placements(("pod",), mesh)


@pytest.mark.parametrize("mesh", [SmallMesh(), FakeMesh()], ids=["2x4", "16x16"])
def test_a2a_groups_hold_the_expert_blocks_in_order(mesh):
    """The expert groups of a2a (``_ep_ranks``, which ``_ep_group`` checks
    its flattened group against) against the blocks that the experts'
    ``Shard(0)`` on each expert axis gives the ranks of a row-major mesh:
    DTensor splits the expert dim over the mesh dims in order, so the rank
    at (data d, model m) holds block ``d * M + m`` of ``("data",
    "model")``, and block ``m`` of ``("model",)`` within its row ``d``."""
    D, M = mesh.shape["data"], mesh.shape["model"]
    rank = lambda d, m: d * M + m  # noqa: E731
    both = _ep_ranks(mesh, ("data", "model"))
    assert len(both) == 1 and len(both[0]) == D * M
    for d in range(D):
        for m in range(M):
            assert both[0][d * M + m] == rank(d, m)
    rows = _ep_ranks(mesh, ("model",))
    assert rows == [[rank(d, m) for m in range(M)] for d in range(D)]
    assert _ep_ranks(mesh, ("data",)) == [[rank(d, m) for d in range(D)] for m in range(M)]


def test_shard_is_the_identity_without_a_mesh_and_refuses_plain_tensors_under_one(meshes):
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.current_mesh() is None
    assert shd.shard(x, "batch", None) is x
    assert shd.like(x, x) is x
    assert shd.whole_groups(x, 1, 3) is x
    meshes(SmallMesh())
    with pytest.raises(TypeError, match="plain Tensor"):
        shd.shard(x, "batch", None)

