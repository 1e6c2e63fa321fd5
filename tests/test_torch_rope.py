"""The rope kernel's wrappers (``kernels/rope.py``) on the CPU, and the
kernel against its plain version on the card.

The plain versions must be exactly what the model ran before the kernel:
``models/common.py``'s ``rope``, kept below as ``rope_before``, and the ring
write of ``decode_attend`` (remainder, arange, two index writes). The card
route's checks run here with the device check bypassed and the library
replaced by a sentinel (``card_route``). The kernel itself runs only on a
CUDA device (``card``).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels.rope import rope_append_plain, rope_plain
from repro_torch.models import attention as attn_mod


class NoLibrary(Exception):
    pass


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route without a card (as in
    test_torch_dense_variants.py, which imports JAX; this file does not, so
    its card test runs where JAX is absent): every input takes the kernel's
    checks, and reaching the library raises NoLibrary."""
    monkeypatch.setattr(_build, "use_plain", lambda name, *t: False)

    def no_library(*a, **k):
        raise NoLibrary

    monkeypatch.setattr(_build, "load_library", no_library)


def rope_before(x, positions, theta):
    """models/common.py's rope as the model ran it before the kernel."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions.float()[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def append_before(q, k_new, v_new, pos, k_cache, v_cache, theta):
    """decode_attend's rope and ring write as the model ran them before."""
    B, C = k_cache.shape[:2]
    q = rope_before(q, pos[:, None], theta)
    k_new = rope_before(k_new, pos[:, None], theta)
    slot = torch.remainder(pos.long(), C)
    bidx = torch.arange(B)
    k_cache[bidx, slot] = k_new[:, 0].reshape(B, -1)
    v_cache[bidx, slot] = v_new[:, 0].reshape(B, -1)
    return q


def randn(seed, *shape, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,Hq,KV,theta", [(16, 4, 2, 10_000.0),
                                            (64, 32, 8, 10_000.0),
                                            (96, 8, 8, 10_000.0),
                                            (128, 12, 2, 1e6)])
@pytest.mark.parametrize("positions", ["arange", "batch", "decode"])
def test_rope_plain_equals_the_former_rope(dtype, hd, Hq, KV, theta, positions):
    B, S = 2, (1 if positions == "decode" else 37)
    q = randn(1, B, S, Hq, hd, dtype=dtype)
    k = randn(2, B, S, KV, hd, dtype=dtype)
    pos = {"arange": torch.arange(S, dtype=torch.int32),
           "batch": torch.randint(0, 20_000, (B, S), dtype=torch.int32,
                                  generator=torch.Generator().manual_seed(11)),
           "decode": torch.tensor([[5], [16_383]], dtype=torch.int32)}[positions]
    assert torch.equal(rope_plain(q, pos, theta), rope_before(q, pos, theta))
    q2, k2 = ops.rope(q, k, pos, theta)
    assert torch.equal(q2, rope_before(q, pos, theta))
    assert torch.equal(k2, rope_before(k, pos, theta))


def _ring_case(dtype, C, pos, hd=16, Hq=4, KV=2):
    B = len(pos)
    q = randn(3, B, 1, Hq, hd, dtype=dtype)
    k = randn(4, B, 1, KV, hd, dtype=dtype)
    v = randn(5, B, 1, KV, hd, dtype=dtype)
    ring = randn(6, 2, B, C, KV * hd, dtype=dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32), ring


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["slot 0", "slot C-1", "slot C (wrap)",
                                  "mixed rows"])
def test_rope_append_plain_equals_rope_and_index_writes(dtype, case):
    C = 64
    pos = {"slot 0": [0, 0], "slot C-1": [C - 1, C - 1],
           "slot C (wrap)": [C, 3 * C], "mixed rows": [0, C - 1, C, 2 * C + 5]}[case]
    q, k, v, p, ring = _ring_case(dtype, C, pos)
    mine, before = ring.clone(), ring.clone()
    out = ops.rope_append(q, k, v, p, mine[0], mine[1], 10_000.0)
    gold = append_before(q, k, v, p, before[0], before[1], 10_000.0)
    assert torch.equal(out, gold) and torch.equal(mine, before)
    assert torch.equal(rope_append_plain(q, k, v, p, ring[0].clone(),
                                         ring[1].clone(), 10_000.0), gold)
    # only slot pos % C of each row changed
    changed = (mine != ring).any(-1)
    for b, t in enumerate(pos):
        assert set(torch.nonzero(changed[0, b]).flatten().tolist()) <= {t % C}


def test_rope_append_plain_over_a_sliding_window_ring():
    """A windowed config's ring of `window` slots, written step after step
    past its end: every step equals the former rope and index writes."""
    C = 8
    q, k, v, _, ring = _ring_case(torch.bfloat16, C, [0, 0, 0])
    mine, before = ring.clone(), ring.clone()
    for t in range(3 * C + 3):
        p = torch.tensor([t, t + 5, t + C], dtype=torch.int32)
        out = ops.rope_append(q, k, v, p, mine[0], mine[1], 10_000.0)
        gold = append_before(q, k, v, p, before[0], before[1], 10_000.0)
        assert torch.equal(out, gold) and torch.equal(mine, before)


def _attn_cfg(**kw):
    cfg = get_config("dcache-agent-150m").reduced()
    return dataclasses.replace(cfg, dtype="float32", **kw)


def test_decode_attend_on_cpu_equals_the_former_path():
    """decode_attend (plain route) against the former rope, index writes
    and plain decode attention, at a sliding-window ring."""
    cfg = _attn_cfg(sliding_window=8)
    p = attn_mod.init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    B, C, hd, kvh = 2, 8, cfg.head_dim_, cfg.n_kv_heads
    x = randn(7, B, 1, cfg.d_model)
    pos = torch.tensor([3, 19], dtype=torch.int32)
    ring = randn(8, 2, B, C, kvh * hd)
    mine, before = ring.clone(), ring.clone()
    out, _, _ = attn_mod.decode_attend(p, cfg, x, pos, mine[0], mine[1])
    q, k_new, v_new = attn_mod._project_qkv(p, cfg, x)
    q = append_before(q.reshape(B, 1, -1, hd), k_new, v_new, pos, before[0],
                      before[1], cfg.rope_theta)
    kc = before[0].view(B, C, kvh, hd).transpose(1, 2)
    vc = before[1].view(B, C, kvh, hd).transpose(1, 2)
    o = ops.decode_attention(q[:, 0], kc, vc, pos, window=8)
    assert torch.equal(mine, before)
    assert torch.equal(out, o.reshape(B, 1, -1) @ p["wo"])


def test_attend_is_train_backpropagates_through_torch_ops(monkeypatch):
    """Under is_train attend ropes with differentiable torch ops and never
    calls the kernel's wrapper; every projection gets a gradient."""
    cfg = _attn_cfg()
    p = attn_mod.init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    for t in p.values():
        t.requires_grad_(True)

    def no_kernel(*a, **k):
        raise AssertionError("is_train reached ops.rope")

    monkeypatch.setattr(ops, "rope", no_kernel)
    x = randn(9, 2, 12, cfg.d_model)
    attn_mod.attend(p, cfg, x, is_train=True).square().sum().backward()
    for name in ("wq", "wk", "wv", "wo"):
        g = p[name].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0


def test_wrappers_on_cpu_take_plain_without_the_library(no_library):
    q, k, v, p, ring = _ring_case(torch.float32, 16, [3, 40])
    qr, kr = ops.rope(q, k, p[:, None], 10_000.0)
    assert torch.equal(qr, rope_plain(q, p[:, None], 10_000.0))
    assert torch.equal(kr, rope_plain(k, p[:, None], 10_000.0))
    mine, gold = ring.clone(), ring.clone()
    assert torch.equal(ops.rope_append(q, k, v, p, mine[0], mine[1], 10_000.0),
                       rope_append_plain(q, k, v, p, gold[0], gold[1], 10_000.0))
    assert torch.equal(mine, gold)
    cfg = _attn_cfg()
    pa = attn_mod.init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    attn_mod.attend(pa, cfg, randn(10, 1, 5, cfg.d_model))


def card_calls(hd=64, dtype=torch.bfloat16, q=None, k=None, pos=None,
               ring=None):
    """Both entry points at one head dim, each input replaceable."""
    B, Hq, KV, C = 2, 8, 2, 16
    q = torch.zeros((B, 1, Hq, hd), dtype=dtype) if q is None else q
    k = torch.zeros((B, 1, KV, hd), dtype=dtype) if k is None else k
    pos = torch.zeros(B, dtype=torch.int32) if pos is None else pos
    ring = torch.zeros((B, C, KV * hd), dtype=dtype) if ring is None else ring
    return {"rope": lambda: ops.rope(q, k, pos[:, None], 10_000.0),
            "rope_append": lambda: ops.rope_append(q, k, k, pos, ring, ring,
                                                   10_000.0)}


@pytest.mark.parametrize("name", ["rope", "rope_append"])
def test_wrappers_refuse_on_the_card_route(card_route, name):
    """Odd head dims, a non-contiguous last dimension and non-int32
    positions raise before the library is reached; so does a ring view off
    16 bytes (rope_append). Accepted calls, misaligned q included (the
    kernel's scalar path), get as far as the library."""
    with pytest.raises(ValueError, match="even"):
        card_calls(hd=15)[name]()
    with pytest.raises(ValueError, match="even"):
        card_calls(hd=1024)[name]()
    strided = torch.zeros((2, 1, 8, 128))[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        card_calls(q=strided, dtype=torch.float32)[name]()
    with pytest.raises(TypeError, match="int32"):
        card_calls(pos=torch.zeros(2, dtype=torch.int64))[name]()
    with pytest.raises(TypeError, match="dtype"):
        card_calls(q=torch.zeros((2, 1, 8, 64)))[name]()
    for hd in (16, 32, 64, 96, 128) + ((6,) if name == "rope" else ()):
        with pytest.raises(NoLibrary):
            card_calls(hd=hd)[name]()
    off = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 1, 8, 64)
    with pytest.raises(NoLibrary):
        card_calls(q=off)[name]()


def test_rope_append_refuses_a_misaligned_or_mismatched_ring(card_route):
    ring = torch.zeros(2 * 16 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 128)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        card_calls(ring=ring)["rope_append"]()
    with pytest.raises(ValueError, match="rings"):
        card_calls(ring=torch.zeros((2, 16, 64), dtype=torch.bfloat16))["rope_append"]()
    q = torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 2, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rings"):
        card_calls(q=q, k=k)["rope_append"]()
    with pytest.raises(ValueError, match=r"\(B,\) int32"):
        card_calls(pos=torch.zeros((2, 1), dtype=torch.int32))["rope_append"]()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_equals_plain_on_the_card(card, dtype):
    """On the card the kernel's q, k and ring equal the plain version's bit
    for bit: prefill and decode shapes at each served head dim, a wrapped
    ring slot, a misaligned q (the scalar path) and broadcast positions."""
    torch.manual_seed(0)
    for hd, Hq, KV, theta in ((64, 32, 8, 10_000.0), (128, 48, 8, 1e6),
                              (96, 32, 32, 10_000.0), (16, 4, 2, 10_000.0)):
        q = torch.randn(2, 37, Hq, hd, device=card).to(dtype)
        k = torch.randn(2, 37, KV, hd, device=card).to(dtype)
        for pos in (torch.arange(37, dtype=torch.int32, device=card),
                    torch.randint(0, 16_384, (2, 37), dtype=torch.int32,
                                  device=card)):
            q2, k2 = ops.rope(q, k, pos, theta)
            assert torch.equal(q2, rope_plain(q, pos, theta))
            assert torch.equal(k2, rope_plain(k, pos, theta))
        off = torch.randn(2 * Hq * hd + 1, device=card).to(dtype)[1:]
        qm = off.view(2, 1, Hq, hd)
        pm = torch.tensor([5, 4_099], dtype=torch.int32, device=card)
        assert torch.equal(ops.rope(qm, k[:, :1], pm[:, None], theta)[0],
                           rope_plain(qm, pm[:, None], theta))
        C = 64
        ring = torch.randn(2, 2, C, KV * hd, device=card).to(dtype)
        for p in ([0, C - 1], [C, 3 * C + 7]):
            p = torch.tensor(p, dtype=torch.int32, device=card)
            mine, gold = ring.clone(), ring.clone()
            v = torch.randn(2, 1, KV, hd, device=card).to(dtype)
            out = ops.rope_append(q[:, :1], k[:, :1], v, p, mine[0], mine[1], theta)
            ref = rope_append_plain(q[:, :1], k[:, :1], v, p, gold[0], gold[1], theta)
            assert torch.equal(out, ref) and torch.equal(mine, gold)
