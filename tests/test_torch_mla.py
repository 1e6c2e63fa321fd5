"""DeepSeek-V2's pieces in the port, on the CPU at small sizes with seeded
random weights, and its two attention kernels against their plain versions
on the card.

- yarn: ``rope_inv_freq`` against the published formula (restated below
  from modeling_deepseek.py as ``published_yarn``), bit for bit; the softmax
  scale;
- the latent decode: ``mla_decode_plain`` (absorbed, over a latent ring)
  against the decompressed attention of the same tokens, within 1e-5 in
  fp32 (the two forms sum the same products in another order);
- rope with a frequency table and a ring write whose v is wider than k;
  the flash plain version at key 192 and value 128;
- the model: latent prefill then decode steps through the ring against the
  decompressed full forward of the same tokens (fp32, 1e-4: the absorbed
  decode and the decompressed prefill round alike but sum in another
  order); the engine serves the reduced config;
- the expert layer: softmax over every expert then the top-k, not
  renormalised; experts and shared experts at ``d_expert``, not ``d_ff``;
  no drop at a decode step of 64 rows x 6 choices; Mixtral's capacities and
  outputs bit for bit what they were before these fields existed (the
  parent tree's ``mlp_moe`` restated in this file).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_IDS, ARCH_IDS, alloc_cache, get_config
from repro_torch.configs.base import MoEConfig, reference_fields
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.mla_decode import mla_decode_plain
from repro_torch.kernels.rope import rope_append_plain, rope_plain
from repro_torch.models import mlp_moe as tmoe
from repro_torch.models import model as tmodel
from repro_torch.models.common import mla_softmax_scale, rope_inv_freq
from repro_torch.serving import ServingEngine

DSV2 = "deepseek-v2-lite"


def small(dtype="float32", **kw):
    """The reduced deepseek-v2-lite: 2 layers (one dense, one MoE), 4 heads,
    latent 32, rope 8, 4 experts of 32 top-2 with one shared, yarn."""
    return dataclasses.replace(get_config(DSV2).reduced(), dtype=dtype,
                               vocab_size=512, **kw)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_registered_apart_from_the_references_ids():
    cfg = get_config(DSV2)
    assert DSV2 not in ARCH_IDS and DSV2 not in ALL_IDS
    assert cfg.is_mla and cfg.moe_layer_mask() == (False,) + (True,) * 26
    assert cfg.param_count() + cfg.d_model == 15_706_484_224    # + final norm
    with pytest.raises(ValueError, match="the reference has no such field"):
        reference_fields(cfg)
    assert get_config("mixtral-8x22b").moe.expert_width(16384) == 16384
    assert MoEConfig(d_expert=1408).expert_width(10944) == 1408


def test_latent_ring_layout():
    cfg = get_config(DSV2)
    cache = alloc_cache(cfg, 64, 16384, torch.device("meta"))
    assert sorted(cache) == ["latent", "pos"]
    lat = cache["latent"]
    assert tuple(lat.shape) == (27, 64, 16384, 576) and lat.dtype == torch.bfloat16
    assert lat.numel() * 2 == 32_614_907_904
    with pytest.raises(ValueError, match="latent ring"):
        alloc_cache(dataclasses.replace(cfg, kv_quant=True), 1, 8, torch.device("meta"))


# ---------------------------------------------------------------------------
# yarn
# ---------------------------------------------------------------------------

def published_yarn(dim, base, factor, original, beta_fast, beta_slow):
    """DeepseekV2YarnRotaryEmbedding's inv_freq, as published."""
    def find_correction_dim(num_rotations):
        return (dim * math.log(original / (num_rotations * 2 * math.pi))) / (
            2 * math.log(base))
    low = max(math.floor(find_correction_dim(beta_fast)), 0)
    high = min(math.ceil(find_correction_dim(beta_slow)), dim - 1)
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


@pytest.mark.parametrize("dim", [64, 8])
def test_yarn_frequencies_are_the_published_ones(dim):
    cfg = get_config(DSV2)
    got = rope_inv_freq(cfg, dim, torch.device("cpu"))
    assert torch.equal(got, published_yarn(dim, 10_000.0, 40.0, 4096, 32.0, 1.0))
    # interpolated by parts: theta's frequencies at the high end, /40 at the low
    theta = 10_000.0 ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    assert abs(got[0].item() - theta[0].item()) < 1e-7
    assert abs(got[-1].item() - theta[-1].item() / 40) < 1e-12
    assert rope_inv_freq(get_config("mixtral-8x22b"), 128, torch.device("cpu")) is None
    assert rope_inv_freq(cfg, dim, torch.device("cpu")) is got        # made once


def test_softmax_scale_and_unequal_mscales():
    cfg = get_config(DSV2)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    odd = dataclasses.replace(cfg, rope_scaling=dataclasses.replace(
        cfg.rope_scaling, mscale=1.0))
    with pytest.raises(ValueError, match="mscale"):
        rope_inv_freq(odd, 64, torch.device("cpu"))


def test_rope_with_a_table_and_a_wider_v():
    """rope_plain with ``inv_freq`` is theta's rope when the table is
    theta's; rope_append writes a 512-wide v and a 64-wide roped k into two
    views of one 576-wide ring row."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 3, 4, 64), generator=g)
    pos = torch.arange(3, dtype=torch.int32)
    table = torch.exp(-math.log(1e4) * torch.arange(32, dtype=torch.float32) / 32)
    assert torch.equal(rope_plain(q, pos, 1e4, table), rope_plain(q, pos, 1e4))
    ring = torch.zeros((2, 16, 576))
    k = torch.randn((2, 1, 1, 64), generator=g)
    v = torch.randn((2, 1, 1, 512), generator=g)
    p = torch.tensor([3, 20], dtype=torch.int32)
    yt = rope_inv_freq(get_config(DSV2), 64, torch.device("cpu"))
    out = ops.rope_append(q[:, :1], k, v, p, ring[..., 512:], ring[..., :512], 1e4, yt)
    assert torch.equal(out, rope_plain(q[:, :1], p[:, None], 1e4, yt))
    assert torch.equal(ring[0, 3, :512], v[0, 0, 0]) and torch.equal(ring[1, 4, :512], v[1, 0, 0])
    assert torch.equal(ring[1, 4, 512:], rope_plain(k, p[:, None], 1e4, yt)[1, 0, 0])
    assert ring[:, 5:].abs().sum() == 0


# ---------------------------------------------------------------------------
# the latent decode and flash at 192 / 128
# ---------------------------------------------------------------------------

def decompressed(q_nope, q_pe, c, k_pe, w_uk, w_uv, scale):
    """Per-head attention of one query a row over its C latent rows, K and V
    decompressed: K = [c W_UK_h | k_pe], V = c W_UV_h."""
    k_nope = torch.einsum("bcr,hnr->bchn", c, w_uk)            # (B,C,H,nope)
    v = torch.einsum("bcr,hrv->bchv", c, w_uv)
    s = (torch.einsum("bhn,bchn->bhc", q_nope, k_nope)
         + torch.einsum("bhp,bcp->bhc", q_pe, k_pe)) * scale
    return torch.einsum("bhc,bchv->bhv", torch.softmax(s, -1), v)


def test_absorbed_latent_decode_equals_the_decompressed_attention():
    g = torch.Generator().manual_seed(2)
    B, H, C, r, nope, rope, vd = 3, 4, 12, 32, 16, 8, 16
    q_nope = torch.randn((B, H, nope), generator=g)
    q_pe = torch.randn((B, H, rope), generator=g)
    ring = torch.randn((B, C, r + rope), generator=g)
    w_uk = torch.randn((H, nope, r), generator=g) / r ** 0.5
    w_uv = torch.randn((H, r, vd), generator=g) / r ** 0.5
    pos = torch.tensor([0, 5, 30], dtype=torch.int32)         # 1, 6 and C valid
    q_lat = torch.einsum("bhn,hnr->bhr", q_nope, w_uk)
    o_lat = mla_decode_plain(torch.cat([q_lat, q_pe], -1), ring, pos, 0.3, latent=r)
    got = torch.einsum("bhr,hrv->bhv", o_lat, w_uv)
    for b, n in enumerate((1, 6, C)):
        slots = [(int(pos[b]) - o) % C for o in range(n)]
        want = decompressed(q_nope[b:b + 1], q_pe[b:b + 1], ring[b:b + 1, slots, :r],
                            ring[b:b + 1, slots, r:], w_uk, w_uv, 0.3)
        torch.testing.assert_close(got[b:b + 1], want, atol=1e-5, rtol=1e-5)
    assert torch.equal(ops.mla_decode(torch.cat([q_lat, q_pe], -1), ring, pos, 0.3, r),
                       o_lat)


def test_flash_plain_takes_a_value_width_and_a_scale():
    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 4, 9, 192), generator=g)
    k = torch.randn((1, 4, 9, 192), generator=g)
    v = torch.randn((1, 4, 9, 128), generator=g)
    out = flash_attention_plain(q, k, v, scale=0.1)
    assert tuple(out.shape) == (1, 4, 9, 128)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.1
    s = s.masked_fill(torch.ones(9, 9, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v, atol=1e-6, rtol=1e-6)


class NoLibrary(Exception):
    pass


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route without a card: every input takes the
    kernel's checks, and reaching the library raises NoLibrary."""
    monkeypatch.setattr(_build, "use_plain", lambda name, *t: False)

    def no_library(*a, **k):
        raise NoLibrary

    monkeypatch.setattr(_build, "load_library", no_library)


def test_wrappers_take_the_latent_shapes_and_refuse_others(card_route):
    bf = torch.bfloat16
    q, k = torch.zeros((1, 16, 8, 192), dtype=bf), torch.zeros((1, 16, 8, 192), dtype=bf)
    v = torch.zeros((1, 16, 8, 128), dtype=bf)
    with pytest.raises(NoLibrary):                 # 192 / 128 in bf16: built
        ops.flash_attention(q, k, v, scale=0.1)
    with pytest.raises(ValueError, match="head dim 192"):
        ops.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="head dim 128 with values of 64"):
        ops.flash_attention(q[..., :128], k[..., :128], v[..., :64])
    ring = torch.zeros((2, 64, 576), dtype=bf)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NoLibrary):
        ops.mla_decode(torch.zeros((2, 16, 576), dtype=bf), ring, pos, 0.1)
    with pytest.raises(NoLibrary):                 # a strided layer view of a ring
        ops.mla_decode(torch.zeros((2, 16, 576), dtype=bf),
                       torch.zeros((3, 2, 64, 576), dtype=bf)[1], pos, 0.1)
    for q2, r2, p2, kind in (
            (torch.zeros((2, 17, 576), dtype=bf), ring, pos, ValueError),
            (torch.zeros((2, 16, 576)), ring.float(), pos, TypeError),
            (torch.zeros((2, 16, 512), dtype=bf), ring, pos, ValueError),
            (torch.zeros((2, 16, 576), dtype=bf), ring, pos.long(), ValueError),
            (torch.zeros((2, 16, 576), dtype=bf),
             torch.zeros((2, 64, 580), dtype=bf)[..., 4:], pos, ValueError)):
        with pytest.raises(kind):
            ops.mla_decode(q2, r2, p2, 0.1)
    with pytest.raises(ValueError, match="value of 512"):
        ops.mla_decode(torch.zeros((2, 16, 576), dtype=bf), ring, pos, 0.1, 256)


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

def test_prefill_then_latent_decode_equal_the_full_forward():
    """fp32: a prefill of 11 tokens, then 4 absorbed decode steps through the
    latent ring, against a decompressed prefill of all 15 tokens: the
    logits at each position within 1e-4 (absorption only reorders sums),
    and the ring rows written at decode equal the full prefill's."""
    cfg = small()
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 15))).int()
    full_cache, _ = tmodel.prefill_step(cfg, p, {"tokens": toks}, max_len=24)
    h, _ = tmodel.forward(cfg, p, {"tokens": toks}, is_train=False)
    want = tmodel._unembed(cfg, p, h)
    cache, logits = tmodel.prefill_step(cfg, p, {"tokens": toks[:, :11]}, max_len=24)
    torch.testing.assert_close(logits[:, 0], want[:, 10], atol=1e-4, rtol=1e-4)
    for t in range(11, 15):
        logits, cache = tmodel.decode_step(cfg, p, toks[:, t:t + 1], cache)
        torch.testing.assert_close(logits[:, 0], want[:, t], atol=1e-4, rtol=1e-4)
    assert cache["pos"].tolist() == [15, 15]
    torch.testing.assert_close(cache["latent"][:, :, :15], full_cache["latent"][:, :, :15],
                               atol=1e-5, rtol=1e-5)


def test_training_route_matches_serving_route():
    cfg = small()
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (1, 9))).int()
    a, _ = tmodel.forward(cfg, p, {"tokens": toks}, is_train=True)
    b, _ = tmodel.forward(cfg, p, {"tokens": toks}, is_train=False)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    total, m = tmodel.loss_fn(cfg, p, {"tokens": toks, "targets": toks})
    assert torch.isfinite(total) and m["aux_loss"] > 0


def test_engine_serves_the_reduced_config_in_bf16():
    cfg = small("bfloat16")
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, p, max_batch=4, max_len=64, device="cpu")
    reqs = [eng.submit("where is the nearest river? " * i, 6) for i in range(1, 6)]
    eng.run_until_done()
    assert all(r.done and 1 <= len(r.out_ids) <= 6 for r in reqs)
    assert sorted(eng.cache) == ["latent", "pos"] and eng.replays == 0


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

def test_softmax_over_all_then_top_k_not_renormalised():
    cfg = dataclasses.replace(small(), moe=dataclasses.replace(
        small().moe, n_experts=8, top_k=6))
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((1, 5, cfg.d_model), generator=torch.Generator().manual_seed(6))
    dispatch, combine, logits = tmoe._routing(p, cfg, x)
    probs = torch.softmax(logits, -1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = combine.sum(-1)                                     # (G,T,E)
    for t in range(5):
        chosen = top.indices[0, t, :6]
        assert set(torch.nonzero(gates[0, t]).flatten().tolist()) == set(chosen.tolist())
        torch.testing.assert_close(gates[0, t, chosen], top.values[0, t, :6])
        assert gates[0, t].sum() < 1                            # not renormalised
    # the Mixtral scoring renormalises over the chosen k
    mix = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, scoring="topk_softmax"))
    _, combine, _ = tmoe._routing(p, mix, x)
    torch.testing.assert_close(combine.sum((-1, -2)), torch.ones(1, 5))


def test_experts_and_shared_experts_take_the_expert_width():
    cfg = get_config(DSV2)
    shapes = {k: tuple(v.shape) for k, v in tmoe.init_moe(
        dataclasses.replace(cfg, d_model=16, moe=dataclasses.replace(cfg.moe, n_experts=2)),
        torch.Generator().manual_seed(0), "meta").items()}
    assert shapes == {"router": (16, 2), "we_gate": (2, 16, 1408),
                      "we_up": (2, 16, 1408), "we_down": (2, 1408, 16),
                      "ws_gate": (16, 2816), "ws_up": (16, 2816), "ws_down": (2816, 16)}
    p = tmodel.init_model(small(), torch.Generator().manual_seed(0), "cpu")
    assert "mlp" in p["layers"][0] and tuple(p["layers"][0]["mlp"]["w_up"].shape) == (64, 128)
    assert tuple(p["layers"][1]["moe"]["we_up"].shape) == (4, 64, 32)


def test_a_decode_step_of_64_rows_by_6_drops_nothing():
    cfg = get_config(DSV2)
    assert tmoe.moe_capacity(cfg, 64, decode=True) == 64
    assert tmoe.moe_capacity(cfg, 1024) == 120                  # prefill: capped
    assert tmoe.moe_capacity(cfg, 10) == 60                     # 10 x 6 <= 64
    small_cfg = dataclasses.replace(small(), moe=dataclasses.replace(
        small().moe, n_experts=8, top_k=6))
    p = tmoe.init_moe(small_cfg, torch.Generator().manual_seed(0), "cpu")
    # every row routes to the same six experts: the worst case
    x = torch.randn((1, 1, small_cfg.d_model)).expand(64, 1, -1).contiguous()
    dispatch, _, _ = tmoe._routing(p, small_cfg, x.reshape(1, 64, -1), decode=True)
    assert dispatch.sum().item() == 64 * 6
    capped, _, _ = tmoe._routing(p, small_cfg, x.reshape(1, 64, -1))
    assert capped.sum().item() < 64 * 6                         # a prefill group drops
    y = tmoe.moe(p, small_cfg, x)
    assert torch.allclose(y, y[:1].expand_as(y))


# the expert layer as it was before the port's DeepSeek fields existed (the
# parent tree's moe_capacity, _routing and moe, restated): Mixtral's layer
# must still compute exactly this
def parent_capacity(cfg, group_tokens):
    mc = cfg.moe
    if group_tokens * mc.top_k <= 64:
        return group_tokens * mc.top_k
    return max(int(group_tokens * mc.top_k * tmoe.CAPACITY_FACTOR / mc.n_experts),
               mc.top_k)


def parent_routing(p, cfg, xg):
    mc = cfg.moe
    G, T, _ = xg.shape
    E, K = mc.n_experts, mc.top_k
    C = parent_capacity(cfg, T)
    logits = (xg @ p["router"]).float()
    gate_vals, idx = tmoe._top_k(logits, K)
    gate_vals = torch.softmax(gate_vals, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, E).float()
    flat = onehot.transpose(1, 2).reshape(G, K * T, E)
    pos_flat = (torch.cumsum(flat, dim=1) - 1.0) * flat
    pos = pos_flat.reshape(G, K, T, E).transpose(1, 2)
    dispatch = torch.zeros((G, T, E, C), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    for k in range(K):
        oh_e = onehot[:, :, k, :]
        pos_t = torch.sum(pos[:, :, k, :] * oh_e, dim=-1)
        keep = (pos_t < C).float()
        oh_c = torch.nn.functional.one_hot(pos_t.long().clamp(max=C - 1), C).float()
        d_k = (oh_e * keep[..., None])[..., :, None] * oh_c[..., None, :]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_vals[:, :, k, None, None]
    return dispatch, combine, logits


def parent_moe(p, cfg, x):
    B, S, D = x.shape
    T = tmoe.GROUP_TOKENS if (B * S) % tmoe.GROUP_TOKENS == 0 else B * S
    xg = x.reshape(-1, T, D)
    dispatch, combine, _ = parent_routing(p, cfg, xg)
    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)
    ye = tmoe._experts(p, xe)
    return torch.einsum("gecd,gtec->gtd", ye, combine.to(x.dtype)).reshape(B, S, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 2048), (1, 40), (32, 1), (2, 16), (4, 1)])
def test_mixtral_expert_layer_is_bit_for_bit_unchanged(dtype, B, S):
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(), dtype=dtype)
    mp = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(B * 1000 + S).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)).to(cfg.torch_dtype)
    T = 1024 if (B * S) % 1024 == 0 else B * S
    assert tmoe.moe_capacity(cfg, T, decode=S == 1) == parent_capacity(cfg, T)
    for got, want in zip(tmoe._routing(mp, cfg, x.reshape(-1, T, cfg.d_model), S == 1),
                         parent_routing(mp, cfg, x.reshape(-1, T, cfg.d_model))):
        assert torch.equal(got, want)
    assert torch.equal(tmoe.moe(mp, cfg, x), parent_moe(mp, cfg, x))


def test_mixtral_capacities_at_the_cells_groups():
    cfg = get_config("mixtral-8x22b")
    assert [tmoe.moe_capacity(cfg, t) for t in (32, 1024, 2048, 4096)] == [64, 320, 640, 1280]
    assert tmoe.moe_capacity(cfg, 32, decode=True) == 64        # 32 rows x 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")


@pytest.mark.card
def test_latent_kernels_equal_their_plain_versions_on_the_card(card):
    """The latent decode kernel against its plain version (bf16 2e-2, as
    chip_smoke.py holds the attention kernels) at 16 heads over rings of
    64 and 4,096 slots with ragged positions (0, 1, C - 1, C, 3C + 7); flash
    at 192 / 128 against flash_attention_plain; the rope kernel with the
    yarn table and the 512-wide ring write bit for bit."""
    g = torch.Generator(device=card).manual_seed(0)
    bf = torch.bfloat16
    for C in (64, 4096):
        pos = torch.tensor([0, 1, C - 1, C, 3 * C + 7], dtype=torch.int32, device=card)
        q = torch.randn((5, 16, 576), generator=g, device=card).to(bf)
        ring = torch.randn((2, 5, C, 576), generator=g, device=card).to(bf)[1]
        out = ops.mla_decode(q, ring, pos, 0.1)
        gold = mla_decode_plain(q, ring, pos, 0.1)
        assert (out.float() - gold.float()).abs().max().item() <= 2e-2
    q = torch.randn((1, 16, 300, 192), generator=g, device=card).to(bf)
    k = torch.randn((1, 16, 300, 192), generator=g, device=card).to(bf)
    v = torch.randn((1, 16, 300, 128), generator=g, device=card).to(bf)
    out = ops.flash_attention(q, k, v, scale=0.11)
    assert (out.float() - flash_attention_plain(q, k, v, scale=0.11).float()
            ).abs().max().item() <= 2e-2
    yt = rope_inv_freq(get_config(DSV2), 64, card)
    qp = torch.randn((4, 1, 16, 192), generator=g, device=card).to(bf)[..., 128:]
    kp = torch.randn((4, 1, 1, 64), generator=g, device=card).to(bf)
    vp = torch.randn((4, 1, 1, 512), generator=g, device=card).to(bf)
    p = torch.tensor([0, 63, 64, 9000], dtype=torch.int32, device=card)
    mine, gold = (torch.randn((4, 64, 576), generator=g, device=card).to(bf)
                  for _ in range(2))
    gold.copy_(mine)
    a = ops.rope_append(qp, kp, vp, p, mine[..., 512:], mine[..., :512], 1e4, yt)
    b = rope_append_plain(qp, kp, vp, p, gold[..., 512:], gold[..., :512], 1e4, yt)
    assert torch.equal(a, b) and torch.equal(mine, gold)
