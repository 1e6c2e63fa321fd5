"""The port's checkpoints against the JAX package's: the mirrors of
tests/test_checkpoint.py on torch trees, the msgpack codec against the
``msgpack`` package, records equal to JAX's, and a checkpoint written by
either side's ``TrainLoop`` restored by the other's, bit for bit.

Every comparison here is exact: the format moves bytes, never values.
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.distributed import checkpoint as jckpt
from repro.models import Init, init_model as jax_init_model, unbox
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain
from repro_torch.bridge import params_from_numpy, to_jax_layout
from repro_torch.configs import get_config
from repro_torch.distributed import _msgpack
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.elastic import mesh_transition_plan, reshard_tree
from repro_torch.distributed.sharding import single_pod_rules
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import init_model
from repro_torch.training import AdamWConfig, TrainLoop
from test_torch_rwkv import noisy_jax_params


def tree():
    return {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.bfloat16)},
            "meta": {"step": torch.tensor(7, dtype=torch.int64)}}


# ---------------------------------------------------------------------------
# mirrors of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip_including_bf16(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = tree()
    ck.save(7, t)
    r = ck.restore(7, like=t)
    assert torch.equal(r["params"]["w"], t["params"]["w"])
    assert r["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(r["params"]["b"], t["params"]["b"])
    assert int(r["meta"]["step"]) == 7
    assert ck.last_save["step"] == 7 and ck.last_save["bytes"] > 0


def test_restore_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree())
    assert ck.available_steps() == [3, 4]      # gc kept last 2
    assert ck.restore_latest(like=tree()) is not None


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree())
    ck.save(2, tree())
    d = ck._step_dir(2)
    shard = [f for f in os.listdir(d) if f.endswith(".ckpt")][0]
    with open(os.path.join(d, shard), "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00garbage\x00")
    assert ck.available_steps() == [1]         # 2 is invalid now
    assert ck.restore_latest(like=tree()) is not None   # fell back to 1
    with pytest.raises(FileNotFoundError):
        ck.restore(2)


def test_partial_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000009"))  # no manifest
    assert ck.available_steps() == [1]


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = tree()
    th = ck.save_async(5, t)
    t["params"]["w"].add_(100)                 # after the snapshot: not saved
    ck.wait()
    assert not th.is_alive()
    assert ck.available_steps() == [5]
    r = ck.restore(5, like=t)
    assert torch.equal(r["params"]["w"],
                       torch.arange(12, dtype=torch.float32).reshape(3, 4))


def test_elastic_reshard_local_mesh():
    mesh = make_local_mesh("cpu")
    vals = {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
            "b": torch.ones((4,), dtype=torch.bfloat16)}
    axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    placed = reshard_tree(vals, axes, mesh, single_pod_rules())
    np.testing.assert_array_equal(placed["w"].numpy(), vals["w"])
    assert placed["b"].dtype == torch.bfloat16 and placed["w"].device.type == "cpu"
    with pytest.raises(NotImplementedError):   # a logical 16x16 mesh
        reshard_tree(vals, axes, make_production_mesh(), single_pod_rules())
    with pytest.raises(ValueError):            # axes of the wrong rank
        reshard_tree(vals, {"w": ("embed",), "b": ("mlp",)}, mesh,
                     single_pod_rules())


def test_mesh_transition_plan():
    plan = mesh_transition_plan({"data": 16, "model": 16},
                                {"pod": 2, "data": 16, "model": 16})
    assert "grow" in plan["pod"]
    assert plan["data"] == "keep 16"
    assert plan == jax_mesh_plan({"data": 16, "model": 16},
                                 {"pod": 2, "data": 16, "model": 16})
    assert mesh_transition_plan({"data": 16}, {"data": 4}) == \
        jax_mesh_plan({"data": 16}, {"data": 4})


def jax_mesh_plan(old, new):
    from repro.distributed.elastic import mesh_transition_plan as jplan
    return jplan(old, new)


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

# each length at and around every size boundary of the formats
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
        -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


def _str(n):
    return ("é" * (n // 2)) + ("a" * (n % 2))   # n utf-8 bytes


leaf = st.one_of(
    st.sampled_from(INTS), st.integers(-2**63, 2**64 - 1),
    st.sampled_from(LENGTHS).map(_str), st.text(max_size=40),
    st.sampled_from(LENGTHS).map(lambda n: bytes(range(256)) * (n // 256)
                                 + bytes(n % 256)),
    st.binary(max_size=40))


@st.composite
def containers(draw):
    kind = draw(st.sampled_from(["list", "tuple", "map", "long-list", "long-map"]))
    if kind.startswith("long"):
        n = draw(st.sampled_from([15, 16, 65535, 65536]))
        if kind == "long-map":
            return {f"k{i}": i for i in range(n)}
        return list(range(n))
    items = draw(st.lists(leaf, max_size=20))
    if kind == "map":
        return {f"key{i}": v for i, v in enumerate(items)}
    return tuple(items) if kind == "tuple" else items


@settings(max_examples=60, deadline=None)
@given(st.one_of(leaf, containers(),
                 st.lists(st.dictionaries(st.text(max_size=8), leaf,
                                          max_size=6), max_size=5)))
def test_msgpack_bytes_and_round_trip(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == ref
    assert _msgpack.unpackb(ref) == msgpack.unpackb(ref, raw=False)


@pytest.mark.parametrize("n", [2**64, -2**63 - 1])
def test_msgpack_int_out_of_range(n):
    with pytest.raises(OverflowError):
        msgpack.packb(n)
    with pytest.raises(OverflowError):
        _msgpack.packb(n)


@pytest.mark.parametrize("obj", [None, True, 1.5, {1: "a"}, {"a": object()}])
def test_msgpack_refuses_types_outside_the_subset(obj):
    with pytest.raises(TypeError):
        _msgpack.packb(obj)


@pytest.mark.parametrize("obj,kw", [(None, {}), (True, {}), (False, {}),
                                    (1.5, {}), (2.5, {"use_single_float": True})])
def test_msgpack_unpack_raises_on_other_type_bytes(obj, kw):
    with pytest.raises(ValueError, match="type byte"):
        _msgpack.unpackb(msgpack.packb([obj], **kw))


def test_msgpack_unpack_raises_on_truncated_and_trailing_data():
    data = msgpack.packb([{"path": "x", "data": b"1234"}], use_bin_type=True)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(data[:-1])
    with pytest.raises(ValueError, match="after"):
        _msgpack.unpackb(data + b"\x00")


# ---------------------------------------------------------------------------
# records and files against JAX's
# ---------------------------------------------------------------------------

ARCHS = ["dcache-agent-150m", "rwkv6-7b", "qwen1.5-32b", "mixtral-8x22b",
         "llama4-maverick-400b-a17b", "hymba-1.5b"]
# llama4 at 4 layers: two super-layers, so dec/mlp and dec/moe regroup
LAYERS = {"llama4-maverick-400b-a17b": 4}


def loop_state(arch, seed=0):
    """A TrainLoop checkpoint's contents for the reduced ``arch`` in bf16,
    as JAX trees and as the port's: params (rwkv6 and qwen1.5's QKV biases
    with noise on their zero leaves), random fp32 moments, and step 5."""
    kw = {"n_layers": LAYERS[arch]} if arch in LAYERS else {}
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    if arch == "rwkv6-7b":
        _, tree = noisy_jax_params(jcfg, seed)
    else:
        jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                          dtype=jcfg.jnp_dtype), jcfg))
        tree = jax.tree.map(np.asarray, jp)
        attn, rng = tree["dec"]["attn"], np.random.default_rng(seed + 20)
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(
                    attn[name].dtype)
    rng = np.random.default_rng(seed + 10)
    mu, nu = (jax.tree.map(lambda a: rng.normal(0, s, a.shape).astype(np.float32),
                           tree) for s in (1e-2, 1e-4))
    jax_state = {"params": jax.tree.map(jnp.asarray, tree),
                 "opt_state": {"step": jnp.asarray(5, jnp.int32),
                               "mu": jax.tree.map(jnp.asarray, mu),
                               "nu": jax.tree.map(jnp.asarray, nu)}}
    f32 = dict(device="cpu", dtype=torch.float32)
    port_state = {"params": params_from_numpy(tree, tcfg, device="cpu"),
                  "opt_state": {"step": torch.tensor(5, dtype=torch.int32),
                                "mu": params_from_numpy(mu, tcfg, **f32),
                                "nu": params_from_numpy(nu, tcfg, **f32)}}
    return jcfg, tcfg, jax_state, port_state


def port_ckpt_tree(tcfg, state, step):
    o = state["opt_state"]
    return {"params": to_jax_layout(state["params"], tcfg),
            "opt_state": {"step": o["step"], "mu": to_jax_layout(o["mu"], tcfg),
                          "nu": to_jax_layout(o["nu"], tcfg)},
            "meta": {"step": step}}


@pytest.mark.parametrize("arch", ARCHS)
def test_records_and_msgpack_bytes_equal_jax(arch):
    _, tcfg, jstate, tstate = loop_state(arch)
    jrecs = jckpt._tree_to_records(dict(jstate, meta={"step": 5}))
    trecs = tckpt._tree_to_records(port_ckpt_tree(tcfg, tstate, 5))
    assert [r["path"] for r in trecs] == [r["path"] for r in jrecs]
    assert "['params']['dec']['norm1']" in {r["path"] for r in trecs}
    assert {r["dtype"] for r in trecs} == {"bfloat16", "<f4", "<i4", "<i8"}
    assert trecs == jrecs
    assert _msgpack.packb(trecs) == msgpack.packb(jrecs, use_bin_type=True)


def _bits(t):
    """A leaf's exact bits as numpy (bf16 as its 16-bit pattern)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def assert_same_state(jloop, tloop, tcfg):
    jt = dict(params=jloop.params, opt_state=jloop.opt_state)
    tt = port_ckpt_tree(tcfg, dict(params=tloop.params,
                                   opt_state=tloop.opt_state), 0)
    jflat = jax.tree_util.tree_flatten_with_path(jt)[0]
    tflat = list(tckpt.flatten_with_path({k: tt[k] for k in jt}))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        ab, bb = _bits(a), _bits(b)
        assert ab.dtype == bb.dtype and ab.shape == bb.shape, path
        np.testing.assert_array_equal(ab, bb, err_msg=str(path))
    assert tloop.opt_state["step"].dtype == torch.int32
    assert jloop.step_idx == tloop.step_idx


def data_iter():
    while True:
        yield {}


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_train_loop_checkpoint_restores_in_port(arch, tmp_path):
    jax_checkpoint_restores_in_port(arch, tmp_path)


def jax_checkpoint_restores_in_port(arch, tmp_path):
    """A checkpoint of JAX's TrainLoop restored by the port's, bit for bit."""
    jcfg, tcfg, jstate, _ = loop_state(arch)
    jloop = jtrain.TrainLoop(jcfg, jopt.AdamWConfig(), jstate["params"],
                             data_iter(),
                             checkpointer=jckpt.Checkpointer(str(tmp_path)))
    jloop.opt_state, jloop.step_idx = jstate["opt_state"], 5
    jloop._checkpoint()
    tparams = init_model(tcfg, torch.Generator().manual_seed(1), "cpu")
    tloop = TrainLoop(tcfg, AdamWConfig(), tparams, data_iter(),
                      checkpointer=Checkpointer(str(tmp_path)))
    assert tloop.restore_if_available()
    assert tloop.step_idx == 5
    assert_same_state(jloop, tloop, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_train_loop_checkpoint_restores_in_jax(arch, tmp_path, monkeypatch):
    port_checkpoint_restores_in_jax(arch, tmp_path, monkeypatch)


def port_checkpoint_restores_in_jax(arch, tmp_path, monkeypatch):
    """A zlib checkpoint of the port's TrainLoop: its bytes equal to JAX's
    records, restored by JAX's TrainLoop bit for bit."""
    monkeypatch.setattr(tckpt, "zstandard", None)     # the card's machine
    jcfg, tcfg, jstate, tstate = loop_state(arch)
    tloop = TrainLoop(tcfg, AdamWConfig(), tstate["params"], data_iter(),
                      checkpointer=Checkpointer(str(tmp_path)))
    assert tloop.ckpt.codec == "zlib"
    tloop.opt_state, tloop.step_idx = tstate["opt_state"], 5
    tloop._checkpoint()
    shard = tmp_path / "step_00000005" / "shard_0000.ckpt"
    raw = zlib.decompress(shard.read_bytes())
    assert raw == msgpack.packb(jckpt._tree_to_records(dict(
        jstate, meta={"step": 5})), use_bin_type=True)
    jparams, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(3),
                                           dtype=jcfg.jnp_dtype), jcfg))
    jloop = jtrain.TrainLoop(jcfg, jopt.AdamWConfig(), jparams, data_iter(),
                             checkpointer=jckpt.Checkpointer(str(tmp_path)))
    assert jloop.restore_if_available()
    assert jloop.step_idx == 5
    assert_same_state(jloop, tloop, tcfg)


def test_zstd_shard_restores_with_zstandard_and_raises_without(tmp_path,
                                                             monkeypatch):
    pytest.importorskip("zstandard")
    jckpt.Checkpointer(str(tmp_path)).save(3, {"w": np.arange(6, dtype=np.float32)})
    shard = tmp_path / "step_00000003" / "shard_0000.ckpt"
    assert shard.read_bytes()[:4] == tckpt._ZSTD_MAGIC
    ck = Checkpointer(str(tmp_path))
    assert ck.codec == "zstd"
    r = ck.restore(3, like={"w": 0})
    assert torch.equal(r["w"], torch.arange(6, dtype=torch.float32))
    monkeypatch.setattr(tckpt, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        Checkpointer(str(tmp_path)).restore_latest(like={"w": 0})


def test_restore_without_like_gives_paths_and_missing_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree())
    leaves = ck.restore(1)
    assert sorted(leaves) == ["['meta']['step']", "['params']['b']",
                              "['params']['w']"]
    with pytest.raises(KeyError):
        ck.restore(1, like={"params": {"nope": 0}})
    assert ck.restore_latest(like={"params": {"nope": 0}}) is None
