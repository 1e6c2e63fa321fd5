"""The port's sharding rules, meshes and parameter axes against the JAX
package's: the mirrors of tests/test_sharding.py on a duck-typed mesh, the
axes and shapes of every parameter, and the spec of every leaf of the
full-width configs on both production meshes under all four rule tables
(shapes only: no weights, no devices)."""
import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models import Init, init_model as jax_init_model, unbox
from repro_torch.bridge import param_axes, param_shapes, to_jax_layout
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import (P, constrain, logical_to_spec,
                                              multi_pod_rules, sharding_context,
                                              single_pod_rules, tree_shardings)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import init_model


class FakeMesh:
    """Duck-typed mesh exposing .shape mapping (enough for spec derivation)."""
    def __init__(self, shape):
        self.shape = shape


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})

# ---------------------------------------------------------------------------
# mirrors of tests/test_sharding.py
# ---------------------------------------------------------------------------


def test_basic_weight_spec():
    spec = logical_to_spec(("embed", "mlp"), (4096, 16384), MESH1,
                           single_pod_rules())
    assert spec == P("data", "model")


def test_divisibility_fallback_vocab():
    # 49155 % 16 != 0 -> vocab axis falls back to replication
    spec = logical_to_spec(("vocab", "embed"), (49155, 2048), MESH1,
                           single_pod_rules())
    assert spec == P(None, "data")
    spec2 = logical_to_spec(("vocab", "embed"), (49408, 2048), MESH1,
                            single_pod_rules())
    assert spec2 == P("model", "data")


def test_batch_one_replicates():
    spec = logical_to_spec(("batch", "seq", "act_embed"), (1, 524288, 4096),
                           MESH1, single_pod_rules())
    assert spec == P(None, None, None)


def test_multi_pod_batch_axis():
    spec = logical_to_spec(("batch", "seq"), (256, 4096), MESH2,
                           multi_pod_rules())
    assert spec == P(("pod", "data"), None)


def test_multi_axis_prefix_fallback():
    # batch=16 divisible by data(16) but not pod*data(32): the longest
    # divisible prefix, ("pod",), spelt as "pod"
    spec = logical_to_spec(("batch",), (16,), MESH2, multi_pod_rules())
    assert spec == P("pod")


def test_mesh_axis_not_reused_in_one_spec():
    spec = logical_to_spec(("mlp", "kv"), (16384, 1024), MESH1,
                           single_pod_rules())
    flat = []
    for e in spec:
        if e is None:
            continue
        flat.extend([e] if isinstance(e, str) else list(e))
    assert len(flat) == len(set(flat))
    assert spec == P("model", None)


def test_empty_name_means_replicated():
    spec = logical_to_spec(("", "embed"), (7, 2048), MESH1, single_pod_rules())
    assert spec == P(None, "data")


def test_production_mesh_axes_present():
    rules = multi_pod_rules()
    assert rules["embed"] == ("pod", "data")
    assert rules["batch"] == ("pod", "data")


# ---------------------------------------------------------------------------
# rule tables, meshes and the one-device context
# ---------------------------------------------------------------------------

TABLES = {
    "single": lambda m: m.single_pod_rules(),
    "multi": lambda m: m.multi_pod_rules(),
    "expert": lambda m: m.expert_parallel_rules(m.multi_pod_rules()),
    "serve": lambda m: m.serve_rules(m.single_pod_rules()),
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_rule_tables_equal_jax(table):
    assert TABLES[table](tsh) == TABLES[table](jsh)


def test_production_meshes():
    m1, m2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert m1.shape == {"data": 16, "model": 16} and m1.devices is None
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    assert logical_to_spec(("embed",), (4096,), m2, multi_pod_rules()) == \
        P(("pod", "data"))


def test_sharding_context_one_device_and_refuses_more():
    mesh = make_local_mesh("cpu")
    assert mesh.shape == {"data": 1} and mesh.devices == [torch.device("cpu")]
    x = torch.ones((4, 8))
    assert constrain(x, ("batch", "act_embed")) is x       # no context
    with sharding_context(mesh, single_pod_rules()):
        assert constrain(x, ("batch", "act_embed")) is x
        with pytest.raises(ValueError):
            constrain(x, ("batch",))
    with pytest.raises(NotImplementedError):
        with sharding_context(make_production_mesh(), single_pod_rules()):
            pass
    assert tsh._CTX.mesh is None


# ---------------------------------------------------------------------------
# parameter axes and shapes, and every leaf's spec at full width
# ---------------------------------------------------------------------------

ARCHS = ["dcache-agent-150m", "rwkv6-7b", "qwen3-4b", "granite-3-2b",
         "phi3-mini-3.8b", "qwen1.5-32b", "mixtral-8x22b",
         "llama4-maverick-400b-a17b", "hymba-1.5b"]


def jax_abstract(cfg):
    """(shapes, axes) of the JAX parameter tree, built abstractly."""
    vals, axes = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                           abstract=True), cfg))
    return jax.tree.map(lambda s: tuple(s.shape), vals), axes


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_and_shapes_equal_jax(arch, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    shapes, axes = jax_abstract(jcfg)
    assert param_axes(tcfg) == axes
    assert param_shapes(tcfg) == shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_port_init(arch):
    cfg = get_config(arch).reduced()
    p = to_jax_layout(init_model(cfg, torch.Generator().manual_seed(0), "cpu"),
                      cfg)
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == param_shapes(cfg)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_spec_equals_jax(arch, mesh, table):
    assert_every_leaf_spec_equals_jax(arch, mesh, table)


def assert_every_leaf_spec_equals_jax(arch, mesh, table):
    """Every leaf of the full-width ``arch``: the port's spec on ``mesh``
    under rule table ``table`` equals JAX's."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    shapes, axes = jax_abstract(jcfg)
    shardings = tree_shardings(param_axes(tcfg), param_shapes(tcfg), mesh,
                               TABLES[table](tsh))
    jrules = TABLES[table](jsh)
    n = 0
    for (path, ax), s, sh in zip(
            jax.tree_util.tree_flatten_with_path(
                axes, is_leaf=lambda x: isinstance(x, tuple))[0],
            jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)),
            jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
                x, tsh.NamedSharding))):
        want = jsh.logical_to_spec(ax, s, mesh, jrules)
        assert sh.mesh is mesh
        assert tuple(sh.spec) == tuple(want), jax.tree_util.keystr(path)
        n += 1
    assert n == len(jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple)))


def test_expert_specs_mirror_reference():
    """tests/test_perf_features.py::test_serve_rules_divisibility on the
    full-width experts: under expert-parallel rules llama4's 128 experts
    shard over ``data``, mixtral's 8 fall back to replication."""
    ep = tsh.expert_parallel_rules(single_pod_rules())
    assert tsh.serve_rules(single_pod_rules()) == jsh.serve_rules(
        jsh.single_pod_rules())
    got = {}
    for arch in ("llama4-maverick-400b-a17b", "mixtral-8x22b"):
        cfg = get_config(arch)
        specs = tree_shardings(param_axes(cfg), param_shapes(cfg), MESH1, ep)
        got[arch] = tuple(specs["dec"]["moe"]["we_gate"].spec)
    assert got["llama4-maverick-400b-a17b"][1] == "data"
    assert got["mixtral-8x22b"][1] is None
