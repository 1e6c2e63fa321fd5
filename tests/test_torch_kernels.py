"""The port's plain kernel versions against the JAX Pallas kernels.

The Pallas kernels run as tests/test_kernels.py runs them (``repro.kernels.ops``,
interpret mode on the CPU), on the same numpy inputs. Ragged sizes the Pallas
kernels refuse (S % block != 0) go against ``repro.kernels.ref``. Tolerances
are those of tests/test_kernels.py: 3e-5 at fp32, 2e-2 at bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  decode_attention_int8_plain,
                                                  decode_attention_plain,
                                                  group_tiles, max_heads,
                                                  split_geometry)
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import MAX_LANES, geometry, rmsnorm_plain
from repro_torch.kernels.rwkv_wkv import wkv_plain
from test_torch_dense_variants import NoLibrary, card_route  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def arrays(seed, *shapes, dtype="float32"):
    """The same seeded inputs as a JAX array and a torch tensor each."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = rng.normal(0, 1, shape).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol(dtype))


MASKS = {"causal": dict(causal=True), "window": dict(causal=True, window=64),
         "chunk": dict(causal=True, chunk=128), "full": dict(causal=False)}


@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 6, 2, 128, 32),
    (1, 4, 1, 512, 64),
    # head dims 16 (the reduced configs') and 32 at G 1, 2 and 4
    (2, 4, 4, 128, 16), (2, 4, 2, 128, 16), (1, 8, 2, 256, 16),
    (1, 4, 4, 128, 32),
])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_plain_vs_pallas(B, Hq, Hkv, S, d, mask):
    kw = MASKS[mask]
    (jq, tq), (jk, tk), (jv, tv) = arrays(1, (B, Hq, S, d), (B, Hkv, S, d),
                                          (B, Hkv, S, d))
    gold = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    close(flash_attention_plain(tq, tk, tv, **kw), gold, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtypes(dtype):
    (jq, tq), (jk, tk), (jv, tv) = arrays(2, *([(1, 4, 128, 64)] * 3), dtype=dtype)
    gold = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    out = flash_attention_plain(tq, tk, tv)
    assert out.dtype == DTYPES[dtype][1]
    close(out, gold, dtype)


@pytest.mark.parametrize("S", [8, 9, 37])
@pytest.mark.parametrize("mask", ["causal", "window", "chunk"])
def test_flash_plain_ragged_vs_ref(S, mask):
    kw = {"causal": dict(causal=True), "window": dict(causal=True, window=5),
          "chunk": dict(causal=True, chunk=4)}[mask]
    (jq, tq), (jk, tk), (jv, tv) = arrays(3, (1, 12, S, 64), (1, 4, S, 64),
                                          (1, 4, S, 64))
    gold = jref.ref_flash_attention(jq, jk, jv, **kw)
    close(flash_attention_plain(tq, tk, tv, **kw), gold, "float32")


def _pos(seed, B, C):
    return np.random.default_rng(seed).integers(1, 3 * C, B).astype(np.int32)


@pytest.mark.parametrize("B,Hq,Hkv,C,d", [
    (2, 4, 2, 256, 64), (3, 8, 8, 128, 32), (1, 16, 2, 512, 128),
    # head dims 16 (the reduced configs') and 32 at G 1, 2 and 4
    (2, 4, 4, 128, 16), (3, 4, 2, 256, 16), (2, 8, 2, 64, 16),
    (2, 4, 2, 128, 32),
    # groups past one kernel block's 32 heads: G 40, G 64 (MQA), G 40 over
    # two KV heads at d 128
    (2, 40, 1, 128, 64), (1, 64, 1, 128, 64), (1, 80, 2, 128, 128),
])
@pytest.mark.parametrize("mask", ["none", "window", "chunk"])
def test_decode_plain_vs_pallas(B, Hq, Hkv, C, d, mask):
    kw = {"none": {}, "window": dict(window=64), "chunk": dict(chunk=128)}[mask]
    (jq, tq), (jk, tk), (jv, tv) = arrays(4, (B, Hq, d), (B, Hkv, C, d),
                                          (B, Hkv, C, d))
    pos = _pos(5, B, C)
    gold = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=64, **kw)
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(pos), **kw)
    close(out, gold, "float32")


@pytest.mark.parametrize("pos", [[3, 17], [63, 63], [130, 200], [0, 1]])
def test_decode_plain_ring_positions(pos):
    """pos < C (unwritten slots masked), pos = C-1, pos > 2C, pos = 0."""
    B, Hq, Hkv, C, d = 2, 12, 4, 64, 64
    (jq, tq), (jk, tk), (jv, tv) = arrays(6, (B, Hq, d), (B, Hkv, C, d),
                                          (B, Hkv, C, d))
    p = np.asarray(pos, np.int32)
    gold = jops.decode_attention(jq, jk, jv, jnp.asarray(p), block_k=64)
    close(decode_attention_plain(tq, tk, tv, torch.from_numpy(p)), gold,
          "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_dtypes(dtype):
    (jq, tq), (jk, tk), (jv, tv) = arrays(7, (4, 12, 64), (4, 4, 128, 64),
                                          (4, 4, 128, 64), dtype=dtype)
    pos = np.asarray([5, 127, 300, 64], np.int32)
    gold = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=64,
                                 window=100)
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(pos), window=100)
    close(out, gold, dtype)


@pytest.mark.parametrize("shape", [(8, 256), (2, 5, 128), (3, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_vs_pallas(shape, dtype):
    (jx, tx), (jg, tg) = arrays(8, shape, (shape[-1],), dtype=dtype)
    gold = jops.rmsnorm(jx, jg)
    out = rmsnorm_plain(tx, tg)
    assert out.dtype == DTYPES[dtype][1]
    close(out, gold, dtype)


@pytest.mark.parametrize("rows,d", [(1, 768), (4, 768), (257, 768), (257, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_ragged_vs_ref(rows, d, dtype):
    (jx, tx), (jg, tg) = arrays(9, (rows, d), (d,), dtype=dtype)
    close(rmsnorm_plain(tx, tg), jref.ref_rmsnorm(jx, jg), dtype)


@pytest.mark.parametrize("shape", [(4, 1, 64), (4, 1, 768), (4, 1, 4096),
                                   (4, 1, 64, 64), (4, 1, 4, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_vs_pallas_served_widths(shape, dtype):
    """The served widths: d 64 (the rwkv per-head norm), 768 (dense), 4096
    (rwkv), 16 (the reduced rwkv6's per-head norm), at a decode step's 4
    rows."""
    (jx, tx), (jg, tg) = arrays(11, shape, (shape[-1],), dtype=dtype)
    close(rmsnorm_plain(tx, tg), jops.rmsnorm(jx, jg), dtype)


def _rmsnorm_coverage(rows, d, geo):
    """How often the kernel's threads touch each element of a (rows, d) x:
    thread t of block b takes row b * rows_per_block + t // lanes and the
    loads lane, lane + lanes, ... of it (lane = t % lanes), each vec wide."""
    count = np.zeros((rows, d), np.int64)
    t = np.arange(geo.blocks * geo.threads)
    row = (t // geo.threads) * geo.rows_per_block + (t % geo.threads) // geo.lanes
    lane = t % geo.lanes
    for i in range(geo.loads):
        c = lane + i * geo.lanes
        live = (row < rows) & (c < d // geo.vec)
        for e in range(geo.vec):
            np.add.at(count, (row[live], c[live] * geo.vec + e), 1)
    return count


@pytest.mark.parametrize("d", [64, 100, 768, 4096])
@pytest.mark.parametrize("rows", [1, 3, 4, 257])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_geometry(d, rows, elem, aligned):
    """Every element of every row is loaded by exactly one lane; a block is
    128 threads (one row of more lanes); a d that is not a multiple of 16
    bytes, or a pointer off 16 bytes, takes the scalar path."""
    geo = geometry(rows, d, elem, aligned)
    assert (_rmsnorm_coverage(rows, d, geo) == 1).all()
    vector = aligned and d % (16 // elem) == 0
    assert geo.vec == (16 // elem if vector else 1)
    assert geo.lanes & (geo.lanes - 1) == 0 and geo.lanes <= MAX_LANES
    assert 1 <= geo.loads <= (4 if vector else 16)
    assert geo.threads == geo.rows_per_block * geo.lanes == max(128, geo.lanes)
    assert geo.blocks == -(-rows // geo.rows_per_block)


@pytest.mark.parametrize("d,lanes,loads,rows_per_block", [
    (64, 8, 1, 16), (768, 32, 3, 4), (4096, 128, 4, 1)])
def test_rmsnorm_geometry_served_bf16(d, lanes, loads, rows_per_block):
    """bf16 at the served widths: 8 lanes a row of 64, a warp a row of 768,
    4 warps a row of 4096; 16-byte loads."""
    geo = geometry(4, d, 2)
    assert (geo.vec, geo.lanes, geo.loads, geo.rows_per_block) == (
        8, lanes, loads, rows_per_block)


def test_rmsnorm_geometry_refuses_rows_too_wide():
    assert geometry(1, 8192, 2, aligned=False).loads == 16
    assert geometry(1, 8193, 2, aligned=False).loads == 0
    assert geometry(1, 16384, 2).loads == 4
    assert geometry(1, 16384 + 8, 2).loads == 0


def test_wrappers_on_cpu_take_plain_without_the_library(no_library):
    (_, tq), (_, tk), (_, tv) = arrays(10, (1, 4, 16, 32), (1, 2, 16, 32),
                                       (1, 2, 16, 32))
    assert torch.equal(tops.flash_attention(tq, tk, tv),
                       flash_attention_plain(tq, tk, tv))
    q1, kc = tq[:, :, 0], tk
    pos = torch.tensor([20], dtype=torch.int32)
    assert torch.equal(tops.decode_attention(q1, kc, tv, pos),
                       decode_attention_plain(q1, kc, tv, pos))
    g = torch.ones(32)
    assert torch.equal(tops.rmsnorm(tq, g), rmsnorm_plain(tq, g))
    r, k, v = tq, tk.repeat(1, 2, 1, 1), tv.repeat(1, 2, 1, 1)
    w, u = torch.full_like(r, 0.9), torch.ones((16, 32))
    y, s = tops.wkv(r, k, v, w, u)
    y_ref, s_ref = wkv_plain(r, k, v, w, u)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    kq = torch.randint(-127, 128, tk.shape, dtype=torch.int8)
    sc = torch.rand(tk.shape[:3])
    assert torch.equal(tops.decode_attention_int8(q1, kq, kq, sc, sc, pos),
                       decode_attention_int8_plain(q1, kq, kq, sc, sc, pos))


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.rmsnorm(x, torch.empty((64,), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tops.rmsnorm(torch.ones(2, 64), torch.empty((64,), device="meta"))


def _visible(C, p, window=None, chunk=None):
    """The slots the plain version's mask shows at position p of a ring of
    C slots."""
    j = np.arange(C)
    pslot = p - np.mod(p - j, C)
    ok = pslot >= 0
    if window is not None:
        ok &= (p - pslot) < window
    if chunk is not None:
        ok &= np.floor_divide(pslot, chunk) == np.floor_divide(p, chunk)
    return ok


def _piece_slots(C, first, n):
    return [(first + o) % C for o in range(n)]


def _split_merge(q, k, v, pos, *, window=None, chunk=None):
    """The decode kernel's rule in plain torch. Block i of each row reads
    its piece of the row's valid span (``split_geometry``); one warp per
    head keeps a partial (m, l, acc) over it, each slot still passed through
    the ring/window/chunk mask (a masked slot scores -1e30); a block with an
    empty piece is neutral (m = -1e30, l = 0, acc = 0). The partials merge
    by e^(m_i - M), M = max m_i, with the l == 0 guard."""
    B, Hq, d = q.shape
    _, Hkv, C, _ = k.shape
    G = Hq // Hkv
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhcd->bhc", q, kk) * (d ** -0.5)
    out = torch.empty_like(q)
    for b in range(B):
        p = int(pos[b])
        ok = torch.from_numpy(_visible(C, p, window, chunk))
        sb = torch.where(ok[None], s[b], torch.full_like(s[b], NEG_INF))
        ms, ls, accs = [], [], []
        for first, n in split_geometry(C, p, window, chunk):
            mine = torch.zeros(C, dtype=torch.bool)
            mine[_piece_slots(C, first, n)] = True
            sm = torch.where(mine[None], sb, torch.full_like(sb, -torch.inf))
            m = sm.amax(-1).clamp(min=NEG_INF)                              # (Hq,)
            pr = torch.exp(sm - m[:, None])                                 # 0 off piece
            ms.append(m)
            ls.append(pr.sum(-1))
            accs.append(torch.einsum("hc,hcd->hd", pr, vv[b]))
        m_all = torch.stack(ms)
        w = torch.exp(m_all - m_all.amax(0))
        den = (w * torch.stack(ls)).sum(0)
        num = (w[..., None] * torch.stack(accs)).sum(0)
        out[b] = num / torch.where(den == 0, torch.ones_like(den), den)[..., None]
    return out


@pytest.mark.parametrize("C", [64, 100, 512])
@pytest.mark.parametrize("pcase", ["pos<C", "pos=C-1", "pos>2C"])
@pytest.mark.parametrize("mask", ["none", "window", "chunk"])
def test_decode_split_merge_rule(C, pcase, mask):
    """Splitting each row's valid span as the kernel does and merging the
    partials gives the plain version and the JAX reference, fp32 within
    3e-5."""
    kw = {"none": {}, "window": dict(window=48), "chunk": dict(chunk=32)}[mask]
    pos = {"pos<C": [0, 5, 17, C // 2], "pos=C-1": [C - 1] * 4,
           "pos>2C": [2 * C + 1, 2 * C + 7, 3 * C + 3, 5 * C]}[pcase]
    (jq, tq), (jk, tk), (jv, tv) = arrays(11, (4, 12, 64), (4, 4, C, 64),
                                          (4, 4, C, 64))
    p = np.asarray(pos, np.int32)
    out = _split_merge(tq, tk, tv, torch.from_numpy(p), **kw)
    close(out, jref.ref_decode_attention(jq, jk, jv, jnp.asarray(p), **kw),
          "float32")
    np.testing.assert_allclose(
        out.numpy(), decode_attention_plain(tq, tk, tv, torch.from_numpy(p),
                                            **kw).numpy(), **tol("float32"))


@pytest.mark.parametrize("mask", ["none", "window", "chunk"])
def test_decode_split_merge_rule_long_ring(mask):
    """The same at mixtral-decide's ring (16,384 slots) at ~2,000 valid
    positions, where each of the 8 blocks takes ~250 slots, and past the
    ring's end."""
    kw = {"none": {}, "window": dict(window=700), "chunk": dict(chunk=1024)}[mask]
    C = 16384
    (jq, tq), (jk, tk), (jv, tv) = arrays(12, (2, 6, 16), (2, 2, C, 16),
                                          (2, 2, C, 16))
    p = np.asarray([1999, 2 * C + 2741], np.int32)
    assert [n for _, n in split_geometry(C, 1999)] == [250] * 8
    out = _split_merge(tq, tk, tv, torch.from_numpy(p), **kw)
    close(out, jref.ref_decode_attention(jq, jk, jv, jnp.asarray(p), **kw),
          "float32")
    np.testing.assert_allclose(
        out.numpy(), decode_attention_plain(tq, tk, tv, torch.from_numpy(p),
                                            **kw).numpy(), **tol("float32"))


def _hold_pieces(C, p, window=None, chunk=None):
    """The pieces of a row are disjoint, cover exactly the slots the plain
    mask shows, differ in length by less than a 64-slot tile, and each walks
    consecutive positions (a full ring: the ranges of a split by
    capacity)."""
    pieces = split_geometry(C, p, window, chunk)
    assert len(pieces) == min(8, C)
    slots = [_piece_slots(C, first, n) for first, n in pieces]
    flat = [j for sl in slots for j in sl]
    assert len(flat) == len(set(flat)), "pieces overlap"
    assert sorted(flat) == list(np.flatnonzero(_visible(C, p, window, chunk)))
    lengths = [n for _, n in pieces]
    assert max(lengths) - min(lengths) < 64
    if len(flat) == C:
        per = -(-C // len(pieces))
        assert pieces == [(min(C, i * per) % C, min(C, i * per + per) - min(C, i * per))
                          for i in range(len(pieces))]
    else:
        for sl in filter(None, slots):
            held = [p - (p - j) % C for j in sl]
            assert held == list(range(held[0], held[0] + len(held)))


@pytest.mark.parametrize("C", [100, 512, 4096, 16384])
@pytest.mark.parametrize("mask", ["none", "window ends mid-range",
                                  "window wraps past C - 1", "chunk", "long chunk"])
def test_decode_split_geometry_covers_the_visible_span(C, mask):
    """``split_geometry`` at pos 0, 1, 63, 64, C - 1, C and past 2C, with a
    window whose first position falls inside a split by capacity's range, a
    window that wraps past slot C - 1 (pos C + 10) and chunks."""
    kw = {"none": {}, "window ends mid-range": dict(window=3 * C // 8 + 5),
          "window wraps past C - 1": dict(window=48), "chunk": dict(chunk=32),
          "long chunk": dict(chunk=C // 2 + 3)}[mask]
    for p in (0, 1, 63, 64, C - 1, C, C + 10, 2 * C + 37, 5 * C - 1):
        _hold_pieces(C, p, **kw)


def test_decode_split_geometry_random_rows():
    """The same over 2,000 seeded rows: ring, position, window and chunk
    drawn at random (negative positions read nothing)."""
    rng = np.random.default_rng(35)
    for _ in range(2000):
        C = int(rng.choice([1, 2, 7, 8, 9, 63, 64, 65, 100, 512, 1000]))
        p = int(rng.integers(-2, 4 * C + 3))
        window = int(rng.integers(1, 2 * C + 2)) if rng.random() < 0.4 else None
        chunk = int(rng.integers(1, 2 * C + 2)) if rng.random() < 0.3 else None
        _hold_pieces(C, p, window, chunk)


@pytest.mark.parametrize("C,p,window,chunk,pieces", [
    (1, 5, None, None, [(0, 1)]),
    (8, 20, None, None, [(i, 1) for i in range(8)]),
    # full rings: the ranges of a split by capacity, ceil(C / 8) slots each
    (100, 250, None, None, [(13 * i, 13) for i in range(7)] + [(91, 9)]),
    (512, 1000, None, None, [(64 * i, 64) for i in range(8)]),
    # mixtral-decide: ~2,000 valid positions of 16,384, 250 each
    (16384, 1999, None, None, [(250 * i, 250) for i in range(8)]),
    # a window of 48 from slot 4,053 that wraps past slot 4,095
    (4096, 4100, 48, None, [(4053 + 6 * i, 6) for i in range(7)] + [(4095, 6)]),
    # the first token: one block reads it, seven are empty
    (512, 0, None, None, [(0, 1)] + [(1, 0)] * 7),
    # a chunk of 256 from position 512 (slot 0), 189 positions
    (512, 700, None, 256, [(24 * i, 24) for i in range(7)] + [(168, 21)]),
])
def test_decode_split_geometry(C, p, window, chunk, pieces):
    """Each block's (first slot, slots) at a few rows, by hand."""
    assert split_geometry(C, p, window, chunk) == pieces


def test_decode_split_geometry_refuses_empty_ring():
    with pytest.raises(ValueError, match="ring of 0 slots"):
        split_geometry(0, 0)


@pytest.mark.parametrize("G", [1, 3, 7, 16, 17, 20, 21, 32, 33, 40, 41, 64, 97, 128])
@pytest.mark.parametrize("cap", [32, 16])
def test_decode_group_tiles(G, cap):
    """A group is cut into ceil(G / cap) tiles of at most cap heads, as even
    as they come: one tile up to cap (so every served group launches as
    before), none empty, every head in exactly one."""
    n, gt = group_tiles(G, cap)
    assert n == -(-G // cap) and gt <= cap
    assert (n - 1) * gt < G <= n * gt
    heads = [g for t in range(n) for g in range(t * gt, min(G, (t + 1) * gt))]
    assert heads == list(range(G))
    if G <= cap:
        assert (n, gt) == (1, G)


def test_decode_max_heads():
    """32 heads a block, but 16 for the fp32 kernel at d 96 and 128 (its
    512-thread bound); the int8 kernel takes 32 at every head dim."""
    assert {d: max_heads(torch.bfloat16, d) for d in (16, 32, 64, 96, 128)} \
        == dict.fromkeys((16, 32, 64, 96, 128), 32)
    assert {d: max_heads(torch.float32, d) for d in (16, 32, 64, 96, 128)} \
        == {16: 32, 32: 32, 64: 32, 96: 16, 128: 16}
    assert all(max_heads(dt, d, int8=True) == 32
               for dt in (torch.float32, torch.bfloat16) for d in (64, 96, 128))


def _group_tile_replay(q, k, v, pos, cap, **kw):
    """The kernel's cut of each kv head's group in plain torch: tile i's
    warps take heads i * gt + w, a warp past the group's end the group's
    last head (it computes and stores nothing); each tile attends on its
    own, and each real head's row is written once. Returns the output and
    how often each (b, head) row was written."""
    B, Hq, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    n, gt = group_tiles(G, cap)
    out = torch.full_like(q, float("nan"))
    writes = torch.zeros((B, Hq), dtype=torch.int64)
    for h in range(Hkv):
        for t in range(n):
            g0 = t * gt
            heads = [min(g0 + w, G - 1) for w in range(gt)]
            qt = q[:, [h * G + g for g in heads]]
            ot = decode_attention_plain(qt, k[:, h:h + 1], v[:, h:h + 1], pos, **kw)
            for w in range(gt):
                if g0 + w < G:
                    out[:, h * G + g0 + w] = ot[:, w]
                    writes[:, h * G + g0 + w] += 1
    return out, writes


@pytest.mark.parametrize("Hq,Hkv", [(40, 1), (41, 1), (64, 1), (80, 2), (21, 1)])
@pytest.mark.parametrize("cap", [32, 16])
@pytest.mark.parametrize("mask", ["none", "window"])
def test_decode_group_tile_replay(Hq, Hkv, cap, mask):
    """The tiles together give the plain version over the whole group and
    JAX's reference, fp32 within 3e-5, with every head written once."""
    kw = {"none": {}, "window": dict(window=48)}[mask]
    B, C, d = 2, 100, 64
    (jq, tq), (jk, tk), (jv, tv) = arrays(31, (B, Hq, d), (B, Hkv, C, d),
                                          (B, Hkv, C, d))
    p = _pos(32, B, C)
    out, writes = _group_tile_replay(tq, tk, tv, torch.from_numpy(p), cap, **kw)
    assert (writes == 1).all()
    close(out, jref.ref_decode_attention(jq, jk, jv, jnp.asarray(p), **kw),
          "float32")
    np.testing.assert_allclose(
        out.numpy(), decode_attention_plain(tq, tk, tv, torch.from_numpy(p),
                                            **kw).numpy(), **tol("float32"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_check_aligned(dtype):
    """The model's layouts pass; a view offset by one element, or with a
    row stride that is not a multiple of 16 bytes, raises."""
    buf = torch.zeros((2, 16, 4, 65), dtype=dtype)
    cache = torch.zeros((2, 16, 4 * 64), dtype=dtype)
    _build.check_aligned("t", cache.view(2, 16, 4, 64).transpose(1, 2),
                         torch.zeros((2, 16, 12, 64), dtype=dtype).transpose(1, 2),
                         torch.zeros((1, 7, 64), dtype=dtype)[:, 3])
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        _build.check_aligned("t", buf[..., 1:])
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        _build.check_aligned("t", buf[..., :64])


@pytest.mark.parametrize("B,Hq,Hkv,C,d", [
    (2, 4, 4, 128, 16), (3, 4, 2, 100, 16), (2, 8, 2, 64, 16),
    (2, 4, 2, 128, 32), (2, 16, 4, 100, 32),
])
@pytest.mark.parametrize("mask", ["none", "window", "chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_int8_plain_small_head_dims(B, Hq, Hkv, C, d, mask, dtype):
    """The int8 plain version at head dims 16 and 32 against its
    dequantize-then-attend reference: JAX's quantize_kv codes and scales,
    dequantize_kv, then the JAX reference attention."""
    _int8_vs_reference(B, Hq, Hkv, C, d, mask, dtype)


@pytest.mark.parametrize("B,Hq,Hkv,C,d", [
    (2, 40, 1, 100, 64), (1, 64, 1, 128, 64), (1, 80, 2, 64, 128),
])
@pytest.mark.parametrize("mask", ["none", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_int8_plain_large_groups(B, Hq, Hkv, C, d, mask, dtype):
    """The int8 plain version at groups the kernel cuts into tiles (G 40,
    64) against the same dequantize-then-attend reference."""
    _int8_vs_reference(B, Hq, Hkv, C, d, mask, dtype)


def _int8_vs_reference(B, Hq, Hkv, C, d, mask, dtype):
    from repro.models import attention as jattn

    kw = {"none": {}, "window": dict(window=8), "chunk": dict(chunk=8)}[mask]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(21)
    ring = []
    for _ in range(2):
        x = jnp.asarray(rng.normal(0, 1, (B, C, Hkv * d)).astype(np.float32), jdt)
        codes, scales = jattn.quantize_kv(x, Hkv)
        deq = jattn.dequantize_kv(codes, scales, jdt).reshape(
            B, C, Hkv, d).transpose(0, 2, 1, 3)
        tc = torch.from_numpy(np.array(codes)).view(B, C, Hkv, d).transpose(1, 2)
        ts = torch.from_numpy(np.array(scales, np.float32)).to(tdt).transpose(1, 2)
        ring.append((deq, tc, ts))
    (kd, tk, tks), (vd, tv, tvs) = ring
    (jq, tq), = arrays(22, (B, Hq, d), dtype=dtype)
    pos = _pos(23, B, C)
    gold = jref.ref_decode_attention(jq, kd, vd, jnp.asarray(pos), **kw)
    out = decode_attention_int8_plain(tq, tk, tv, tks, tvs, torch.from_numpy(pos),
                                      **kw)
    assert out.dtype == tdt
    close(out, gold, dtype)


@pytest.mark.parametrize("d,Hq", [(64, 40), (64, 64), (128, 32), (96, 21),
                                  (128, 41)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_wrappers_take_any_group_on_the_card_route(card_route, d, Hq,
                                                          dtype):
    """On the card route (the device check bypassed, the library replaced
    by a sentinel) both decode wrappers pass any group G = Hq / Hkv,
    MQA included, to the kernel: no group is refused in Python."""
    q = torch.zeros((2, Hq, d), dtype=dtype)
    k = torch.zeros((2, 1, 64, d), dtype=dtype)
    codes = torch.zeros((2, 1, 64, d), dtype=torch.int8)
    sc = torch.ones((2, 1, 64), dtype=dtype)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NoLibrary):
        tops.decode_attention(q, k, k, pos)
    with pytest.raises(NoLibrary):
        tops.decode_attention_int8(q, codes, codes, sc, sc, pos)
