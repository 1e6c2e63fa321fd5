"""The port's assigned shapes (``repro_torch.configs.shapes``) against the
JAX package's, for every architecture at full width and every shape.

The port's ``input_specs`` gives tensors on the meta device and JAX's gives
``ShapeDtypeStruct``s, so nothing is allocated, ``long_500k`` included.
Every leaf's shape and dtype, ``input_axes``, the skip text of
``shape_applicable``, ``alloc_cache(..., device="meta")`` against
``cache_specs`` (with and without ``kv_quant``) and ``ARCH_IDS`` must be
equal.
"""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs as tconfigs

DTYPES = {torch.int32: jnp.int32, torch.int8: jnp.int8,
          torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_same_leaves(port, ref):
    port, ref = leaves(port), leaves(ref)
    assert sorted(port) == sorted(ref)
    for k, t in port.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(ref[k].shape), k
        assert DTYPES[t.dtype] == ref[k].dtype, (k, t.dtype, ref[k].dtype)


def pair(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch), **kw),
            dataclasses.replace(tconfigs.get_config(arch), **kw))


def test_shape_table_and_arch_ids_equal_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in tconfigs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jconfigs.SHAPES[name])


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ALL_IDS)
def test_input_specs_equal_jax(arch, shape):
    jcfg, tcfg = pair(arch)
    js, ts = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
    assert tconfigs.shape_applicable(tcfg, ts) == jconfigs.shape_applicable(jcfg, js)
    assert_same_leaves(tconfigs.input_specs(tcfg, ts), jconfigs.input_specs(jcfg, js))
    assert tconfigs.input_axes(tcfg, ts) == jconfigs.input_axes(jcfg, js)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "kv_quant"])
@pytest.mark.parametrize("arch", jconfigs.ALL_IDS)
def test_alloc_cache_on_meta_equals_cache_specs(arch, kv_quant):
    jcfg, tcfg = pair(arch, kv_quant=kv_quant)
    for s in jconfigs.SHAPES.values():
        B, S = s.global_batch, s.seq_len
        assert_same_leaves(tconfigs.alloc_cache(tcfg, B, S, torch.device("meta")),
                           jconfigs.cache_specs(jcfg, B, S))


def test_long_500k_skips_only_full_attention_archs():
    skipped = {a for a in tconfigs.ALL_IDS
               if tconfigs.shape_applicable(tconfigs.get_config(a),
                                            tconfigs.LONG_500K)}
    assert skipped == {a for a in tconfigs.ALL_IDS
                       if not tconfigs.get_config(a).supports_long_context}
    assert "rwkv6-7b" not in skipped and "dcache-agent-150m" in skipped
