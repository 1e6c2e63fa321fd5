"""Weight bridge, import hygiene and the device rule of the port."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.model import init_model
from repro_torch.serving import ServingEngine
from test_torch_rwkv import noisy_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
# JAX and the reference, and what the card's machine lacks (the port keeps
# its own msgpack codec and reads bf16 without ml_dtypes)
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "kernel_ab.py"]


def _jax_tree(dtype):
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               dtype=dtype)
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jcfg.jnp_dtype), jcfg))
    return jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_names_shapes_dtypes(dtype):
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(), dtype=dtype)
    tree = _jax_tree(dtype)
    p = params_from_numpy(tree, tcfg, device="cpu")
    assert set(p) == {"embed", "final_norm", "layers"}
    assert len(p["layers"]) == tcfg.n_layers
    assert p["embed"].shape == (tcfg.padded_vocab, tcfg.d_model)
    for l, lp in enumerate(p["layers"]):
        assert set(lp) == {"norm1", "norm2", "attn", "mlp"}
        assert set(lp["attn"]) == {"wq", "wk", "wv", "wo"}
        assert set(lp["mlp"]) == {"w_up", "w_gate", "w_down"}
        for grp in ("attn", "mlp"):
            for k, t in lp[grp].items():
                src = tree["dec"][grp][k][l]
                assert tuple(t.shape) == src.shape, (grp, k)
                assert t.dtype == tcfg.torch_dtype
                np.testing.assert_array_equal(t.float().numpy(),
                                              src.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_params_names_shapes_dtypes(dtype):
    tcfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), dtype=dtype)
    jcfg = dataclasses.replace(jax_get_config("rwkv6-7b").reduced(), dtype=dtype)
    _, tree = noisy_jax_params(jcfg)
    p = params_from_numpy(tree, tcfg, device="cpu")
    assert set(p) == {"embed", "final_norm", "unembed", "layers"}
    assert p["unembed"].shape == (tcfg.d_model, tcfg.padded_vocab)
    np.testing.assert_array_equal(p["unembed"].float().numpy(),
                                  tree["unembed"].astype(np.float32))
    assert len(p["layers"]) == tcfg.n_layers
    for l, lp in enumerate(p["layers"]):
        assert set(lp) == {"norm1", "norm2", "tm", "cm"}
        assert set(lp["tm"]) == set(tree["dec"]["tm"])
        assert {"mu_x", "u", "w0", "ln_x", "la_w", "lb_w", "wo"} <= set(lp["tm"])
        assert set(lp["cm"]) == {"mu_k", "mu_r", "wk", "wv", "wr"}
        for grp in ("tm", "cm"):
            for k, t in lp[grp].items():
                src = tree["dec"][grp][k][l]
                assert tuple(t.shape) == src.shape, (grp, k)
                assert t.dtype == tcfg.torch_dtype
                np.testing.assert_array_equal(t.float().numpy(),
                                              src.astype(np.float32))
        assert lp["tm"]["u"].any() and lp["tm"]["mu_x"].any()


def test_bf16_round_trip_is_exact():
    tree = _jax_tree("bfloat16")
    tcfg = get_config("dcache-agent-150m").reduced()
    p = params_from_numpy(tree, tcfg, device="cpu")
    back = p["embed"].float().numpy()
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, tree["embed"].astype(np.float32))
    again = jax.numpy.asarray(back, jax.numpy.bfloat16)
    np.testing.assert_array_equal(np.asarray(again).view(np.uint16),
                                  tree["embed"].view(np.uint16))


def test_port_init_model_shapes_match_jax_tree():
    tcfg = get_config("dcache-agent-150m").reduced()
    gen = torch.Generator().manual_seed(0)
    p = init_model(tcfg, gen, "cpu")
    ref = params_from_numpy(_jax_tree("bfloat16"), tcfg, device="cpu")
    for k in ("embed", "final_norm"):
        assert p[k].shape == ref[k].shape and p[k].dtype == ref[k].dtype
    for lp, rp in zip(p["layers"], ref["layers"]):
        for grp in ("attn", "mlp"):
            for k in rp[grp]:
                assert lp[grp][k].shape == rp[grp][k].shape
    w = p["layers"][0]["attn"]["wq"].float()
    assert w.abs().max() <= 2.0 / tcfg.d_model ** 0.5 + 1e-6   # truncated at 2 std


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {mod}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .replace(".__init__", "") for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_engine_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               vocab_size=512)
    p = init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tcfg, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(tcfg, torch.Generator().manual_seed(0))
