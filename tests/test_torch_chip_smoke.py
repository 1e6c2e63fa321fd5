"""``chip_smoke.counting_launches`` on the CPU, over a stand-in for the
kernel library: it counts each entry point's successful calls under its
kernel's name and puts the library's entry points back on exit.

chip_smoke.py itself runs only on a CUDA device; importing it here runs
nothing.
"""
import importlib.util
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def stand_in(monkeypatch):
    """chip_smoke and a stand-in library that ``_build.load_library``
    returns: each entry point returns its code in ``codes`` (0, a launch,
    unless a test sets an error code) and records its name."""
    cs = load_chip_smoke()
    called, codes = [], {}

    def entry(name):
        def call(*args):
            called.append(name)
            return codes.get(name, 0)
        return call

    lib = types.SimpleNamespace(**{e: entry(e) for e in cs.LAUNCHERS})
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    return cs, lib, called, codes


def test_counts_successful_calls_by_kernel_name(stand_in):
    cs, lib, called, codes = stand_in
    codes["repro_wkv"] = 700            # an error code: no launch
    with cs.counting_launches() as counts:
        assert lib.repro_rope() == 0
        assert lib.repro_rope() == 0
        assert lib.repro_rmsnorm() == 0
        assert lib.repro_decode_attention_int8() == 0
        assert lib.repro_wkv() == 700
    assert called == ["repro_rope", "repro_rope", "repro_rmsnorm",
                      "repro_decode_attention_int8", "repro_wkv"]
    assert counts == {"rmsnorm": 1, "flash_attention": 0, "decode_attention": 0,
                      "decode_attention_int8": 1, "wkv": 0, "rope": 2}


def test_counts_the_wrappers_card_route_with_rope_append_under_rope(
        stand_in, monkeypatch):
    """The wrappers read the entry point from the library at each call, so
    a count opened after they were imported sees their launches; a wrapper
    whose launch returns an error raises, uncounted."""
    cs, lib, called, codes = stand_in
    monkeypatch.setattr(_build, "use_plain", lambda name, *t: False)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    x, g = torch.zeros((4, 64), dtype=torch.bfloat16), torch.ones(64, dtype=torch.bfloat16)
    q = torch.zeros((2, 1, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 1, 2, 64), dtype=torch.bfloat16)
    ring = torch.zeros((2, 16, 128), dtype=torch.bfloat16)
    pos = torch.zeros(2, dtype=torch.int32)
    with cs.counting_launches() as counts:
        ops.rmsnorm(x, g)
        ops.rope(q, k, pos[:, None], 10_000.0)
        ops.rope_append(q, k, k, pos, ring, ring, 10_000.0)
        codes["repro_rmsnorm"] = 1
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            ops.rmsnorm(x, g)
    assert called == ["repro_rmsnorm", "repro_rope", "repro_rope", "repro_rmsnorm"]
    assert counts == {"rmsnorm": 1, "flash_attention": 0, "decode_attention": 0,
                      "decode_attention_int8": 0, "wkv": 0, "rope": 2}


def test_puts_the_entry_points_back(stand_in):
    cs, lib, called, _ = stand_in
    originals = dict(vars(lib))
    with cs.counting_launches() as counts:
        assert all(getattr(lib, e) is not f for e, f in originals.items())
    assert vars(lib) == originals
    with pytest.raises(KeyError):
        with cs.counting_launches():
            lib.repro_flash_attention()
            raise KeyError("raised inside the block")
    assert vars(lib) == originals
    lib.repro_flash_attention()         # outside any block: not counted
    assert counts == dict.fromkeys(cs.LAUNCHERS.values(), 0)
    assert called == ["repro_flash_attention"] * 2
