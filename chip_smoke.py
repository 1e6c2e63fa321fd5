#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Any failure exits non-zero (nothing is caught). Kernel launches are
counted at the C boundary (``counting_launches``) and held to the exact
numbers each path implies (``expected_launches``). The phases, in order:
  1. build: the kernels of src/repro_torch/kernels/csrc/, each instance's
     ptxas registers and spills (any spill fails), the 12 attention
     instances at head dims 16 and 32, the 12 WKV and the 4 rope ones;
  2. kernels against their plain versions (bf16 2e-2, fp32 1e-4) at every
     served and many ragged shapes (``check_kernels``); misaligned views
     and unbuilt shapes raise and launch nothing; then the kernel timings
     behind PERF.md's kernel table (``time_kernels``);
  3. twelve paths served at full width in bf16 (``SERVED_PATHS``): tokens
     in the vocabulary, exact launches, the unembed within 1e-3 of fp32;
  paged: a full-width PagedKVCache against the engine's ring, bit for bit;
  assigned shapes: decode_32k and prefill_32k (kernel against plain,
     absolutely and row by row; the kernel timings of their table rows),
     train_4k (its memory fit and steps, finite losses, no launch);
  bench: the serving bench's twin, its rows and launches;
  agent: the paper's cache decisions made by the served model over 8
     tasks, then Tables I-III against their locked digests;
  concurrent: the concurrent engine's admission and replication planes
     served by the model beside SimLLM's (34 + 8 decisions), then the six
     concurrent tables against their digests;
  4. CPU (plain versions) against the card (kernels) at fp32: logits within
     1e-3 and the same greedy tokens, for 2-layer full-width and reduced
     paths, the reduced model behind the agent and the concurrent engine,
     and the launchers' --smoke mains;
  5. training: 30 steps through serve_llm.train (the loss falls by 0.5,
     remat dots within 1e-3 of block, no launch), the trained weights
     served; one train step on CPU and card (loss 1e-4, grad_norm 1e-3);
  6. checkpoints: one save, cold restarts on card and CPU bit for bit, the
     restored weights served with the saved ones' tokens; train_tiny;
  7. the card's name and power limit, the kernels' JSON line and the result
     line; the rest goes to chiprun_out/chip_smoke.json.
It imports nothing of JAX or of ``repro``. Without a CUDA device, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.launch.serve import PROMPTS  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# the C entry points that launch a kernel, each with the name its launches
# are counted under (rope_append launches the rope kernel)
LAUNCHERS = {"repro_rmsnorm": "rmsnorm", "repro_flash_attention": "flash_attention",
             "repro_decode_attention": "decode_attention",
             "repro_decode_attention_int8": "decode_attention_int8",
             "repro_wkv": "wkv", "repro_rope": "rope"}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=50, warmup=5):
    """Median of per-call CUDA-event times, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


# host-side API calls that put work on the device (PERF.md section 5)
LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC",
               "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(fn, iters, warmup=True):
    """torch.profiler over ``iters`` calls of fn (after one more unless
    ``warmup`` is False): device time per call by kernel name (us) and the
    launch API calls per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_call, n_launch = {}, 0
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            per_call[a.key] = (per_call.get(a.key, 0.0)
                               + a.self_device_time_total / iters)
        elif a.key in LAUNCH_APIS:
            n_launch += a.count
    return per_call, n_launch / iters


@contextlib.contextmanager
def counting_launches():
    """Count the kernel launches made inside the block at the C boundary:
    each entry point of LAUNCHERS on the kernel library is replaced by a
    wrapper that calls it and counts a call that returned 0 under its
    kernel's name. Yields the counts (every kernel's name, from 0); the
    entry points are put back on exit, also after an exception."""
    from repro_torch.kernels import _build

    lib = _build.load_library()
    counts = dict.fromkeys(LAUNCHERS.values(), 0)
    originals = {entry: getattr(lib, entry) for entry in LAUNCHERS}

    def counted(name, fn):
        def call(*args):
            err = fn(*args)
            if err == 0:
                counts[name] += 1
            return err
        return call

    try:
        for entry, fn in originals.items():
            setattr(lib, entry, counted(LAUNCHERS[entry], fn))
        yield counts
    finally:
        for entry, fn in originals.items():
            setattr(lib, entry, fn)


def kernel_device_us(per_call, needle):
    return sum(t for k, t in per_call.items() if needle in k)


def all_device_us(fn, iters=20):
    """Device time per call of every kernel fn launches (a library call may
    launch several), in us."""
    return sum(device_profile(fn, iters)[0].values())


def bound_ms(nbytes, flops, dtype):
    t_b = nbytes / PEAK_BYTES_S
    t_f = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


# kernel -> last dimension held (head dim; row width for rmsnorm) -> dtype
# -> max abs error against the plain version
HELD = {}


def compare(name, case, out, gold, dtype, errs):
    err = (out.float() - gold.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), gold.float(), atol=tol, rtol=tol)
    log(f"  {name} {case} {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"tol(atol=rtol)={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case}: kernel disagrees with plain version")
    errs[name] = max(errs.get(name, 0.0), err)
    by = HELD.setdefault(name, {}).setdefault(out.shape[-1], {})
    by[str(dtype)[6:]] = max(by.get(str(dtype)[6:], 0.0), err)


def compare_rows(name, case, out, gold, dtype):
    """Each output row's (last dimension's) rms error against that row's own
    rms, held at TOL[dtype]. A softmax spread over n slots gives outputs of
    about 1/sqrt(n), below TOL itself at a 32,768-slot ring, so there the
    absolute hold of ``compare`` cannot see a dropped split or key tile;
    this one can. Returns the per-row ratios."""
    o, g = out.float().flatten(0, -2), gold.float().flatten(0, -2)
    ratio = ((o - g).pow(2).mean(-1).sqrt()
             / g.pow(2).mean(-1).sqrt().clamp_min(1e-30))
    worst, tol = ratio.max().item(), TOL[dtype]
    ok = worst <= tol
    log(f"  {name} {case} {str(dtype)[6:]}: max over {ratio.numel()} rows of "
        f"rms(err)/rms(row)={worst:.3e} (median {ratio.median().item():.3e}) "
        f"tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case}: kernel disagrees with plain "
                             "version relative to the rows' size")
    return ratio


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# phase 3's paths (arch, kv_quant, layers): the MoE configs' depth is cut to
# fit one card
SERVED_PATHS = (("dcache-agent-150m", False, None), ("dcache-agent-150m", True, None),
                ("rwkv6-7b", False, None), ("qwen3-4b", False, None),
                ("granite-3-2b", False, None), ("phi3-mini-3.8b", False, None),
                ("qwen1.5-32b", False, None), ("mixtral-8x22b", False, 12),
                ("llama4-maverick-400b-a17b", False, 4), ("hymba-1.5b", False, None),
                ("seamless-m4t-large-v2", False, None),
                ("llava-next-34b", False, None))
# head dims 16 and 32 (16 is every reduced config's: the smoke launchers and
# the serving bench) at the reduced configs' groups, G 1, 2 and 4
SMALL_HEADS = [(d, Hq, Hkv) for d in (16, 32) for Hq, Hkv in ((4, 4), (4, 2), (8, 2))]
# llava's image request: 2,880 patches (anyres, 5 tiles x 576) before a
# 32-token prompt, in a ring of 4,096 slots; seamless's requests: 256
# frames each (cross_k of cache_specs' max_len // 2 at max_len 512)
IMAGE_TEXT, IMAGE_MAX_LEN, ENC_FRAMES = 32, 4096, 256


def served_shapes():
    """The served paths' rmsnorm row widths (d_model) and attention heads
    (head dim, query heads, KV heads), sorted."""
    from repro_torch.configs import get_config

    cfgs = [get_config(arch) for arch, _, _ in SERVED_PATHS]
    heads = {(c.head_dim_, c.n_attn_heads, c.n_kv_heads)
             for c in cfgs if not c.attn_free}
    return sorted({c.d_model for c in cfgs}), sorted(heads)


# the ptxas log's mangled names of the attention instances at head dims 16
# and 32 (flash's mma and fma kernels, decode and int8 decode, bf16 and
# fp32) and of every WKV instance (prefill and decode, bf16 and fp32, head
# dims 16, 32 and 64)
SMALL_DIM_NAMES = (r"(flash_kernel_mma|flash_kernel_fma|decode_kernel|"
                   r"decode_int8_kernel)I(13__nv_bfloat16|f)?Li(16|32)E")
WKV_NAMES = r"(wkv_kernel_decode|wkv_kernel)I(13__nv_bfloat16|f)Li(16|32|64)E"
# the rope kernel's instances: bf16 and fp32, 16-byte vectors (8 or 4
# elements) and the scalar path (1)
ROPE_NAMES = r"(rope_kernel)I(13__nv_bfloat16|f)Li(1|4|8)E"


def instances(ptxas, names):
    """(kernel<type, d>, registers, spill line) of every instance whose
    mangled name matches ``names`` in the ptxas log."""
    out, lines = [], ptxas.splitlines()
    for i, line in enumerate(lines):
        hit = re.search(names, line)
        if "entry function" in line and hit:
            regs = next(re.search(r"Used (\d+) registers", x).group(1)
                        for x in lines[i + 1:i + 4] if "Used" in x)
            spill = next(x.strip() for x in lines[i + 1:i + 4] if "spill" in x)
            dt = {"13__nv_bfloat16": "bf16", "f": "fp32", None: ""}[hit.group(2)]
            out.append((f"{hit.group(3)} {hit.group(1)} {dt}".strip(), int(regs), spill))
    return out


def check_kernels(errs):
    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    check_rmsnorm_geometry()
    widths, heads = served_shapes()
    for dtype in (torch.bfloat16, torch.float32):
        # every served path's d_model, at a decode step's 4 rows and a
        # prefill's 48 (exact length) and 64 (bucket); d 100 in bf16 is not a
        # multiple of 8: the scalar path; d 16 is the reduced rwkv6's
        # per-head norm (ln_x)
        for rows in (1, 4, 48, 64, 257):
            for dm in sorted({16, 64, 100} | set(widths)):
                x = randn(gen, rows, dm, dtype=dtype)
                g = randn(gen, dm, dtype=dtype)
                compare("rmsnorm", f"rows={rows} d={dm}", ops.rmsnorm(x, g),
                        rmsnorm_plain(x, g), dtype, errs)
        # contiguous views one element off 16 bytes: the scalar path
        for rows, dm in ((4, 768), (4, 4096), (257, 64)):
            x = randn(gen, rows * dm + 1, dtype=dtype)[1:].view(rows, dm)
            g = randn(gen, dm + 1, dtype=dtype)[1:]
            compare("rmsnorm", f"rows={rows} d={dm} misaligned view",
                    ops.rmsnorm(x, g), rmsnorm_plain(x, g), dtype, errs)
        # qwen3-4b's qk_norm: q (B,S,KV,G,hd) and k (B,S,KV,hd) at hd 128
        for shape in ((2, 37, 8, 4, 128), (2, 37, 8, 128)):
            x, g = randn(gen, *shape, dtype=dtype), randn(gen, 128, dtype=dtype)
            compare("rmsnorm", f"qk_norm x={shape}", ops.rmsnorm(x, g),
                    rmsnorm_plain(x, g), dtype, errs)
        # each served path's head dim and heads (the grid follows Hkv, so
        # every (d, Hq, Hkv) is its own case), and d 96 at G = 4, which no
        # path serves
        for d, Hq, Hkv in heads + [(96, 16, 4)] + SMALL_HEADS:
            check_attention(gen, dtype, d, Hq, Hkv, errs)
        check_image_prefill(gen, dtype, errs)
        check_group16(gen, dtype, errs)
        check_group_tiles(gen, dtype, errs)
        for d in HEAD_DIMS:
            check_int8(gen, dtype, d, errs)
        check_rope(gen, dtype, errs)
        check_misaligned(gen, dtype)
        check_refused(gen, dtype)
    check_served_decode(gen, errs)
    check_wkv(errs)


def check_attention(gen, dtype, d, Hq, Hkv, errs):
    """Flash and decode attention at head dim d and group Hq / Hkv: prompts
    of S = 8..512 whose packed rows (S * G) cross a 64-row tile's edge,
    under causal, window, chunk and no mask; decode rings of 64, 100 (not a
    multiple of the 8 splits, the last range short), 256 (seamless's
    cross-attention ring of encoder frames at pos = C - 1) and 512 slots (pos in
    {0, 1, 63, 64}: blocks with empty pieces), with windows and chunks
    and a window that ends inside a split by capacity's range."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    B, tag = 4, f"d={d} G={Hq // Hkv}"
    for S in (8, 9, 32, 37, 64, 256, 512):
        # the model's layouts: q (1,S,Hq,d), k/v (1,S,Hkv,d), seen as (B,H,S,d)
        q = randn(gen, 1, S, Hq, d, dtype=dtype).transpose(1, 2)
        k = randn(gen, 1, S, Hkv, d, dtype=dtype).transpose(1, 2)
        v = randn(gen, 1, S, Hkv, d, dtype=dtype).transpose(1, 2)
        for mask, kw in (("causal", {}), ("window16", {"window": 16}),
                         ("chunk32", {"chunk": 32}),
                         ("full", {"causal": False})):
            compare("flash_attention", f"{tag} S={S} {mask}",
                    ops.flash_attention(q, k, v, **kw),
                    flash_attention_plain(q, k, v, **kw), dtype, errs)
    for C in (64, 100, ENC_FRAMES, 512):
        kc = randn(gen, B, C, Hkv * d, dtype=dtype)   # the cache slice
        vc = randn(gen, B, C, Hkv * d, dtype=dtype)
        k = kc.view(B, C, Hkv, d).transpose(1, 2)
        v = vc.view(B, C, Hkv, d).transpose(1, 2)
        q = randn(gen, B, Hq, d, dtype=dtype)
        pcases = [("pos<C", [0, 5, 17, C // 2]), ("pos=C-1", [C - 1] * B),
                  ("pos>2C", [2 * C + 1, 2 * C + 7, 3 * C + 3, 5 * C])]
        if C == 512:
            pcases.append(("pos={0,1,63,64}", [0, 1, 63, 64]))
        for pcase, pos in pcases:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for mask, kw in (("none", {}), ("window48", {"window": 48}),
                             ("chunk32", {"chunk": 32})):
                compare("decode_attention", f"{tag} C={C} {pcase} {mask}",
                        ops.decode_attention(q, k, v, p, **kw),
                        decode_attention_plain(q, k, v, p, **kw), dtype, errs)
        # a window that ends inside a split (64 slots each at C = 512)
        p = torch.tensor([100, 300, 700, 1000], dtype=torch.int32, device="cuda")
        compare("decode_attention", f"{tag} C={C} window40 ends mid-split",
                ops.decode_attention(q, k, v, p, window=40),
                decode_attention_plain(q, k, v, p, window=40), dtype, errs)


def check_image_prefill(gen, dtype, errs):
    """Flash at llava's heads (d 128, 56 q over 8 KV: G 7) at its image
    request's length, 2,880 patches + 32 text tokens (ragged: S * G =
    20,384 packed rows, 32 past a 64-row tile), and at 2,880 + 37 (20,419
    rows, 3 past a tile), causal."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    for S in (2880 + IMAGE_TEXT, 2880 + 37):
        q = randn(gen, 1, S, 56, 128, dtype=dtype).transpose(1, 2)
        k = randn(gen, 1, S, 8, 128, dtype=dtype).transpose(1, 2)
        v = randn(gen, 1, S, 8, 128, dtype=dtype).transpose(1, 2)
        compare("flash_attention", f"d=128 G=7 S={S} causal (image prefill)",
                ops.flash_attention(q, k, v), flash_attention_plain(q, k, v),
                dtype, errs)


def check_rmsnorm_geometry():
    """The launch geometry the C++ side takes equals kernels/rmsnorm.py's
    ``geometry``, which the CPU tests check, over served, ragged, wide and
    misaligned cases."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import geometry

    lib = _build.load_library()
    res = (ctypes.c_int * 6)()
    n = 0
    for rows in (1, 3, 4, 257):
        for d in (1, 7, 64, 100, 768, 4096, 4100, 16384, 20000):
            for elem in (2, 4):
                for aligned in (True, False):
                    lib.repro_rmsnorm_geometry(rows, d, elem, int(aligned), res)
                    py = tuple(geometry(rows, d, elem, aligned))
                    assert tuple(res) == py, (rows, d, elem, aligned, tuple(res), py)
                    n += 1
    log(f"  rmsnorm geometry: C++ and Python agree in {n} cases "
        f"(d 768 bf16: {geometry(4, 768, 2)})")


def check_group16(gen, dtype, errs):
    """G = 16 query heads over one kv head: a decode block of 16 warps (one
    per head), and 16 heads packed into a flash tile."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain

    q = randn(gen, 1, 37, 16, 64, dtype=dtype).transpose(1, 2)
    k = randn(gen, 1, 37, 1, 64, dtype=dtype).transpose(1, 2)
    v = randn(gen, 1, 37, 1, 64, dtype=dtype).transpose(1, 2)
    compare("flash_attention", "G=16 S=37 causal", ops.flash_attention(q, k, v),
            flash_attention_plain(q, k, v), dtype, errs)
    for C, pos in ((100, [3, 50, 99, 250]), (512, [1100, 1300, 1500, 2047])):
        kc = randn(gen, 4, C, 64, dtype=dtype).view(4, C, 1, 64).transpose(1, 2)
        vc = randn(gen, 4, C, 64, dtype=dtype).view(4, C, 1, 64).transpose(1, 2)
        q = randn(gen, 4, 16, 64, dtype=dtype)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        compare("decode_attention", f"G=16 C={C} window48",
                ops.decode_attention(q, kc, vc, p, window=48),
                decode_attention_plain(q, kc, vc, p, window=48), dtype, errs)


# the benchmark cells' decode steps in bf16: (name, B, Hq, Hkv, d, C, lowest
# pos, highest pos); each row of the batch at its own position
SERVED_DECODE = (("granite decide", 32, 32, 8, 64, 4096, 1164, 2252),
                 ("mixtral decide", 32, 48, 8, 128, 16384, 1164, 2741),
                 ("mixtral react", 32, 48, 8, 128, 16384, 5197, 7751))


def served_pos(gen, B, C, lo, hi, ragged=False):
    """(B,) int32 positions drawn in [lo, hi]; ``ragged`` replaces the
    first rows by pos 0, ~2,000, C - 1 and a wrapped row (2C + 37)."""
    pos = torch.randint(lo, hi + 1, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    if ragged:
        pos[:4] = torch.tensor([0, 1999, C - 1, 2 * C + 37], dtype=torch.int32)
    return pos


def served_ring(gen, B, C, Hkv, d, dtype, int8=False):
    """The model's ring views (B,Hkv,C,d) of a (B,C,Hkv*d) cache, and for
    ``int8`` its codes with their (B,Hkv,C) scales: (k, v, k_scale,
    v_scale)."""
    if int8:
        _, _, k, ks = int8_ring(gen, B, C, Hkv, d, dtype)
        _, _, v, vs = int8_ring(gen, B, C, Hkv, d, dtype)
        return k, v, ks, vs
    k = randn(gen, B, C, Hkv * d, dtype=dtype).view(B, C, Hkv, d).transpose(1, 2)
    v = randn(gen, B, C, Hkv * d, dtype=dtype).view(B, C, Hkv, d).transpose(1, 2)
    return k, v, None, None


def check_served_decode(gen, errs):
    """Decode attention at the three cells' served steps (SERVED_DECODE), a
    ragged mixtral-decide batch (pos 0, ~2,000, C - 1 and a wrapped row
    among the drawn ones) and the int8 kernel at mixtral-decide's shape,
    in bf16 against the plain version (4 rows at a time: its fp32 copy of
    the ring per query head), held absolutely and row by row relative to
    each row's size (outputs of a ~2,000-slot softmax are about the
    absolute tolerance)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_int8_plain, decode_attention_plain)

    dt = torch.bfloat16
    cases = [(name, B, Hq, Hkv, d, C, lo, hi, False, False)
             for name, B, Hq, Hkv, d, C, lo, hi in SERVED_DECODE]
    _, B, Hq, Hkv, d, C, lo, hi = SERVED_DECODE[1]
    cases += [("mixtral decide ragged", B, Hq, Hkv, d, C, lo, hi, True, False),
              ("mixtral decide int8", B, Hq, Hkv, d, C, lo, hi, False, True)]
    for name, B, Hq, Hkv, d, C, lo, hi, ragged, int8 in cases:
        k, v, ks, vs = served_ring(gen, B, C, Hkv, d, dt, int8)
        q = randn(gen, B, Hq, d, dtype=dt)
        pos = served_pos(gen, B, C, lo, hi, ragged)
        with torch.no_grad():
            if int8:
                out = ops.decode_attention_int8(q, k, v, ks, vs, pos)
                gold = torch.cat([decode_attention_int8_plain(
                    q[i:i + 4], k[i:i + 4], v[i:i + 4], ks[i:i + 4], vs[i:i + 4],
                    pos[i:i + 4]) for i in range(0, B, 4)])
            else:
                out = ops.decode_attention(q, k, v, pos)
                gold = torch.cat([decode_attention_plain(
                    q[i:i + 4], k[i:i + 4], v[i:i + 4], pos[i:i + 4])
                    for i in range(0, B, 4)])
        kernel = "decode_attention_int8" if int8 else "decode_attention"
        case = (f"served {name}: q ({B},{Hq},{d}), ring {C}, pos "
                f"{int(pos.min())}-{int(pos.max())}")
        compare(kernel, case, out, gold, dt, errs)
        compare_rows(kernel, case, out, gold, dt)
        del k, v, ks, vs, out, gold
        torch.cuda.empty_cache()


# (Hq, Hkv) past one block's heads: G 40 (two tiles of 20), G 64 (MQA, two
# tiles of 32), G 40 over two KV heads, and G 41 (a last tile one head
# short, whose spare warp stores nothing)
GROUP_TILE_HEADS = ((40, 1), (64, 1), (80, 2), (41, 1))


def check_group_tiles(gen, dtype, errs):
    """Decode and int8 decode at groups larger than one block holds, cut
    into group tiles (GROUP_TILE_HEADS at d 64 and 128; in fp32 also G 32
    and 21 at d 96 and 128, past the 16 heads a block holds there): rings
    of 100 and 512 slots (whole splits masked at pos 0 and 63), no mask
    and a window of 48; each tile's merge stays inside its own cluster."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_int8_plain, decode_attention_plain, group_tiles,
        max_heads)

    B = 4
    cases = [(d, Hq, Hkv) for d in (64, 128) for Hq, Hkv in GROUP_TILE_HEADS]
    if dtype == torch.float32:
        cases += [(d, Hq, 1) for d in (96, 128) for Hq in (32, 21)]
    for d, Hq, Hkv in cases:
        G = Hq // Hkv
        tiles = group_tiles(G, max_heads(dtype, d))
        tiles8 = group_tiles(G, max_heads(dtype, d, int8=True))
        tag = f"d={d} G={G} Hkv={Hkv} tiles={tiles} int8 tiles={tiles8}"
        for C, pos in ((100, [3, 50, 99, 250]), (512, [0, 63, 700, 2047])):
            k = randn(gen, B, C, Hkv * d, dtype=dtype).view(B, C, Hkv, d).transpose(1, 2)
            v = randn(gen, B, C, Hkv * d, dtype=dtype).view(B, C, Hkv, d).transpose(1, 2)
            q = randn(gen, B, Hq, d, dtype=dtype)
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
            for mask, kw in (("none", {}), ("window48", {"window": 48})):
                compare("decode_attention", f"{tag} C={C} {mask}",
                        ops.decode_attention(q, k, v, p, **kw),
                        decode_attention_plain(q, k, v, p, **kw), dtype, errs)
            _, _, k8, ks = int8_ring(gen, B, C, Hkv, d, dtype)
            _, _, v8, vs = int8_ring(gen, B, C, Hkv, d, dtype)
            compare("decode_attention_int8", f"{tag} C={C} none",
                    ops.decode_attention_int8(q, k8, v8, ks, vs, p),
                    decode_attention_int8_plain(q, k8, v8, ks, vs, p), dtype, errs)


def int8_ring(gen, B, C, Hkv, d, dtype):
    """A quantized ring as the kv_quant cache holds it: codes (B,C,KV*hd)
    int8 and scales (B,C,KV) from quantize_kv, and the kernel's
    (B,KV,C,hd) / (B,KV,C) views of them."""
    from repro_torch.models.attention import quantize_kv

    codes, scales = quantize_kv(randn(gen, B, C, Hkv * d, dtype=dtype), Hkv)
    return (codes, scales, codes.view(B, C, Hkv, d).transpose(1, 2),
            scales.transpose(1, 2))


def check_int8(gen, dtype, d, errs):
    """The int8 kernel against its plain version at head dim d: rings of
    64, 100 and 512 slots (whole splits masked or empty at pos in {0, 1,
    63, 64}), G = 3 (d 64; G = 1 and 4 at the other head dims) and G = 16,
    windows and chunks, and a ring whose unwritten slots carry scale 0 and
    whose prefill pad slots carry scale 1.0."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_int8_plain

    def one(case, q, k, v, ks, vs, p, **kw):
        compare("decode_attention_int8", case,
                ops.decode_attention_int8(q, k, v, ks, vs, p, **kw),
                decode_attention_int8_plain(q, k, v, ks, vs, p, **kw), dtype, errs)

    B = 4
    groups = {64: ((12, 4), (16, 1)), 16: ((16, 4), (8, 4), (8, 8), (16, 1)),
              32: ((16, 4), (8, 4), (8, 8), (16, 1))}.get(
                  d, ((16, 4), (8, 8), (16, 1)))
    for C in (64, 100, 512):
        for Hq, Hkv in groups:
            _, _, k, ks = int8_ring(gen, B, C, Hkv, d, dtype)
            _, _, v, vs = int8_ring(gen, B, C, Hkv, d, dtype)
            q = randn(gen, B, Hq, d, dtype=dtype)
            pcases = [("pos<C", [0, 5, 17, C // 2]), ("pos=C-1", [C - 1] * B),
                      ("pos>2C", [2 * C + 1, 2 * C + 7, 3 * C + 3, 5 * C])]
            if C == 512:
                pcases.append(("pos={0,1,63,64}", [0, 1, 63, 64]))
            masks = (("none", {}), ("window48", {"window": 48}),
                     ("chunk32", {"chunk": 32}))
            for pcase, pos in pcases:
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                for mask, kw in masks if Hkv == 4 else masks[1:2]:
                    one(f"d={d} G={Hq // Hkv} C={C} {pcase} {mask}", q, k, v,
                        ks, vs, p, **kw)
    # the engine's ring at the start of a request: real tokens in slots
    # 0..pos, prefill pad slots (codes 0, scale 1.0), never-written slots
    # (codes 0, scale 0)
    C, Hkv = 512, 4
    kc, kscale, k, ks = int8_ring(gen, B, C, Hkv, d, dtype)
    vc, vscale, v, vs = int8_ring(gen, B, C, Hkv, d, dtype)
    pos = [5, 40, 63, 130]
    for b, p in enumerate(pos):
        for codes, sc in ((kc, kscale), (vc, vscale)):
            codes[b, p + 1:] = 0
            sc[b, p + 1:p + 9] = 1.0
            sc[b, p + 9:] = 0.0
    p = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = randn(gen, B, 12, d, dtype=dtype)
    out = ops.decode_attention_int8(q, k, v, ks, vs, p)
    assert torch.isfinite(out.float()).all(), "empty or pad slots gave NaN/inf"
    one(f"d={d} C=512 empty (scale 0) and pad (scale 1) slots", q, k, v, ks,
        vs, p)


# the rope kernel's served shapes: (name, B, S, Hq, KV, hd, C, theta); C > 0
# is a decode step's ring of C slots (rope_append), C = 0 a prefill (rope)
ROPE_SHAPES = (("granite decode", 32, 1, 32, 8, 64, 4096, 10_000.0),
               ("mixtral decode", 32, 1, 48, 8, 128, 16384, 1e6),
               ("granite prefill", 1, 2048, 32, 8, 64, 0, 10_000.0),
               ("mixtral prefill", 1, 8192, 48, 8, 128, 0, 1e6))


def rope_case(gen, dtype, B, S, Hq, KV, hd, C, theta):
    """Inputs of one rope shape: q, k (v and the rings at a decode step,
    positions 0, C - 1, C, and past 2C), and the kernel's and the plain
    version's calls, each returning what it wrote."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rope import rope_append_plain, rope_plain

    q = randn(gen, B, S, Hq, hd, dtype=dtype)
    k = randn(gen, B, S, KV, hd, dtype=dtype)
    if not C:
        pos = torch.arange(S, dtype=torch.int32, device="cuda")
        return (lambda: ops.rope(q, k, pos, theta),
                lambda: (rope_plain(q, pos, theta), rope_plain(k, pos, theta)))
    v = randn(gen, B, S, KV, hd, dtype=dtype)
    first = [0, C - 1, C, 2 * C + 7]
    pos = torch.tensor(first + torch.randint(0, 3 * C, (B - len(first),),
                                             generator=torch.Generator().manual_seed(C)
                                             ).tolist(),
                       dtype=torch.int32, device="cuda")
    rings = randn(gen, 2, B, C, KV * hd, dtype=dtype)
    mine, gold = rings.clone(), rings.clone()
    return (lambda: (ops.rope_append(q, k, v, pos, mine[0], mine[1], theta), mine),
            lambda: (rope_append_plain(q, k, v, pos, gold[0], gold[1], theta), gold))


def check_rope(gen, dtype, errs):
    """The rope kernel against its plain version at the served shapes
    (ROPE_SHAPES), phi3's head dim 96, the reduced configs' 16 and a q view
    off 16 bytes (the scalar path): q, k and the rings compared whole. Bit
    for bit is expected (the plain version's fp32 op order, each product
    rounded); a transcendental that differs shows as a max difference."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rope import rope_plain

    cases = list(ROPE_SHAPES) + [("phi3 prefill", 2, 37, 32, 32, 96, 0, 10_000.0),
                                 ("phi3 decode", 4, 1, 32, 32, 96, 512, 10_000.0),
                                 ("reduced decode", 4, 1, 4, 2, 16, 128, 10_000.0)]
    for name, B, S, Hq, KV, hd, C, theta in cases:
        run, plain = rope_case(gen, dtype, B, S, Hq, KV, hd, C, theta)
        out, gold = run(), plain()
        exact = all(torch.equal(a, b) for a, b in zip(out, gold))
        log(f"  rope {name} {str(dtype)[6:]}: bit for bit {exact}")
        for a, b in zip(out, gold):
            compare("rope", f"{name} {tuple(a.shape)}", a.view(*a.shape[:-1], -1, hd),
                    b.view(*b.shape[:-1], -1, hd), dtype, errs)
    Hq, hd = 32, 64
    q = randn(gen, 4 * Hq * hd + 1, dtype=dtype)[1:].view(4, 1, Hq, hd)
    k = randn(gen, 4, 1, 8, hd, dtype=dtype)
    pos = torch.tensor([[3], [70], [4097], [16000]], dtype=torch.int32, device="cuda")
    out = ops.rope(q, k, pos, 10_000.0)
    for a, b in zip(out, (rope_plain(q, pos, 10_000.0), rope_plain(k, pos, 10_000.0))):
        log(f"  rope misaligned q (scalar path) {str(dtype)[6:]}: bit for bit "
            f"{torch.equal(a, b)}")
        compare("rope", "misaligned q view", a, b, dtype, errs)


def check_misaligned(gen, dtype):
    """A view offset by one element must raise before any launch: the
    attention and WKV kernels copy 16-byte rows, and rope_append refuses a
    ring the decode kernel would refuse before writing into it."""
    from repro_torch.kernels import ops

    Hq, Hkv, S, d = 12, 4, 64, 64
    q = randn(gen, 1, S, Hq, d + 1, dtype=dtype)[..., 1:].transpose(1, 2)
    k = randn(gen, 1, S, Hkv, d, dtype=dtype).transpose(1, 2)
    r = randn(gen, 1, S, Hkv, d + 1, dtype=dtype)[..., 1:]
    rk = randn(gen, 1, S, Hkv, d, dtype=dtype)
    w = torch.full((1, S, Hkv, d), 0.9, device="cuda")
    u = randn(gen, Hkv, d, dtype=dtype)
    # int8 codes (1,KV,S,hd) from a buffer one byte off 16
    codes = torch.zeros(S * Hkv * d + 1, dtype=torch.int8, device="cuda")[1:] \
        .view(1, S, Hkv, d).transpose(1, 2)
    scales = torch.ones((1, Hkv, S), dtype=dtype, device="cuda")
    ring = randn(gen, S * Hkv * d + 1, dtype=dtype)[1:].view(1, S, Hkv * d)
    with counting_launches() as counts:
        for name, call in (
                ("rope_append", lambda: ops.rope_append(
                    rk[:, :1], rk[:, :1], rk[:, :1],
                    torch.zeros(1, dtype=torch.int32, device="cuda"), ring, ring,
                    10_000.0)),
                ("flash_attention", lambda: ops.flash_attention(q, k, k)),
                ("decode_attention", lambda: ops.decode_attention(
                    q[:, :, 0], k, k, torch.zeros(1, dtype=torch.int32, device="cuda"))),
                ("decode_attention_int8", lambda: ops.decode_attention_int8(
                    k[:, :, 0].contiguous(), codes, codes, scales, scales,
                    torch.zeros(1, dtype=torch.int32, device="cuda"))),
                ("wkv", lambda: ops.wkv(r, rk, rk, w, u))):
            try:
                call()
            except ValueError as e:
                log(f"  {name} misaligned view {str(dtype)[6:]}: raised ({e})")
            else:
                raise AssertionError(f"{name}: a misaligned view did not raise")
    assert not any(counts.values()), "a misaligned view launched a kernel"


def check_refused(gen, dtype):
    """On the card a head dim outside HEAD_DIMS (here 80) raises in each
    attention wrapper before any launch, with no fallback; so does WKV at a
    head dim it is not built for (48)."""
    from repro_torch.kernels import ops

    q = randn(gen, 1, 8, 16, 80, dtype=dtype).transpose(1, 2)
    k = randn(gen, 1, 8, 4, 80, dtype=dtype).transpose(1, 2)
    codes = torch.zeros((1, 4, 8, 80), dtype=torch.int8, device="cuda")
    scales = torch.ones((1, 4, 8), dtype=dtype, device="cuda")
    p = torch.zeros(1, dtype=torch.int32, device="cuda")
    calls = [("flash_attention", ValueError, lambda: ops.flash_attention(q, k, k)),
             ("decode_attention", ValueError,
              lambda: ops.decode_attention(q[:, :, 0], k, k, p)),
             ("decode_attention_int8", ValueError, lambda: ops.decode_attention_int8(
                 q[:, :, 0].contiguous(), codes, codes, scales, scales, p))]
    r = randn(gen, 1, 8, 2, 48, dtype=dtype)
    w = torch.full((1, 8, 2, 48), 0.9, device="cuda")
    calls.append(("wkv", ValueError,
                  lambda: ops.wkv(r, r, r, w, randn(gen, 2, 48, dtype=dtype))))
    # rope: an odd head dim
    r15 = randn(gen, 1, 8, 2, 15, dtype=dtype)
    calls.append(("rope", ValueError,
                  lambda: ops.rope(r15, r15, torch.arange(8, dtype=torch.int32,
                                                          device="cuda"), 1e4)))
    with counting_launches() as counts:
        for name, exc, call in calls:
            try:
                call()
            except exc as e:
                log(f"  {name} refused {str(dtype)[6:]}: raised ({e})")
            else:
                raise AssertionError(f"{name}: an unbuilt shape did not raise")
    assert not any(counts.values()), "a refused shape launched a kernel"


def wkv_inputs(gen, B, S, H, hd, dtype):
    """r/k/v (B,S,H,hd) in dtype (k a strided view of a (B,H,S,hd) buffer),
    w fp32 in (0.8, 0.999), u (H,hd) in dtype."""
    r = randn(gen, B, S, H, hd, dtype=dtype)
    k = randn(gen, B, H, S, hd, dtype=dtype).transpose(1, 2)
    v = randn(gen, B, S, H, hd, dtype=dtype)
    w = 0.8 + 0.199 * torch.rand((B, S, H, hd), generator=gen, device="cuda")
    u = randn(gen, H, hd, dtype=dtype)
    return r, k, v, w, u


def same_state(case, s, sp):
    """The kernel's state must equal wkv_plain's bit for bit: both round
    every product and sum of the update separately, in the same order."""
    err = (s - sp).abs().max().item()
    ok = torch.equal(s, sp)
    log(f"  wkv {case} state: max_abs_err={err:.3e} (must be 0) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"wkv {case}: state differs from wkv_plain")


# WKV's (head dim, heads) held in phase 2: rwkv6-7b's 64 heads of 64, the
# reduced config's 4 of 16, and 8 of 32
WKV_HEADS = ((64, 64), (16, 4), (32, 8))


def check_wkv(errs):
    """The WKV kernel against wkv_plain at each built head dim (WKV_HEADS):
    prefill shapes from a zero state (around the staged chunk of T steps:
    T - 1, T, T + 1, and S = 512), B = 4 from a random state, and the
    decode shape from a random state, into a new buffer and in place. y is
    compared in its dtype's tolerance; the fp32 state must be
    bit-identical."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv_wkv import CHUNK_STEPS, HEAD_DIMS, wkv_plain

    assert sorted(hd for hd, _ in WKV_HEADS) == sorted(HEAD_DIMS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for hd, H in WKV_HEADS:
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{str(dtype)[6:]} hd={hd}"
            T = CHUNK_STEPS[dtype]
            for S in sorted({1, 7, 48, 64, 130, T - 1, T, T + 1, 512}):
                r, k, v, w, u = wkv_inputs(gen, 1, S, H, hd, dtype)
                y, s = ops.wkv(r, k, v, w, u)
                yp, sp = wkv_plain(r, k, v, w, u)
                compare("wkv", f"hd={hd} H={H} B=1 S={S} y", y, yp, dtype, errs)
                same_state(f"B=1 S={S} {name}", s, sp)
            for S in (48, 1):
                r, k, v, w, u = wkv_inputs(gen, 4, S, H, hd, dtype)
                s0 = torch.randn((4, H, hd, hd), generator=gen, device="cuda")
                yp, sp = wkv_plain(r, k, v, w, u, s0)
                y, s = ops.wkv(r, k, v, w, u, s0=s0)
                compare("wkv", f"hd={hd} H={H} B=4 S={S} s0 y", y, yp, dtype, errs)
                same_state(f"B=4 S={S} s0 {name}", s, sp)
            # the decode step: S = 1, the state updated in place
            state = s0.clone()
            y, s = ops.wkv(r, k, v, w, u, s0=state, state_out=state)
            assert s.data_ptr() == state.data_ptr()
            compare("wkv", f"hd={hd} H={H} B=4 S=1 s0 in place y", y, yp, dtype, errs)
            same_state(f"B=4 S=1 s0 in place {name}", state, sp)


def time_decode(gen, B, Hq, Hkv, C, d, int8=False, pos=None, plain=True):
    """Decode attention (or its int8 variant) in bf16 at a decode step over
    a ring of C slots, by default full (rows past the ring's end), or at
    ``pos`` ((B,) positions): kernel, plain version and SDPA (bf16 only;
    neither without ``plain``, at a served step's shape, where the plain
    version would copy the ring to fp32 per query head and SDPA read all of
    it), the kernel's profiled device time, its bound (each row's valid
    slots read once) and the card's residency (blocks an SM, clusters at
    once)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_int8_plain, decode_attention_plain, group_tiles,
        max_heads, occupancy, split_geometry)

    dt, es = torch.bfloat16, 2
    n_gt, gt = group_tiles(Hq // Hkv, max_heads(dt, d, int8=int8))
    q = randn(gen, B, Hq, d, dtype=dt)
    full = pos is None
    pos = torch.as_tensor([C + 3, C + 40, 2 * C + 5, 3 * C][:B] if full else pos,
                          dtype=torch.int32, device="cuda")
    valid = sum(min(int(p) + 1, C) for p in pos)
    pieces = split_geometry(C, int(pos[0]))
    res = occupancy(Hkv, C, Hq // Hkv, d, dt, int8=int8)
    k, v, ks, vs = served_ring(gen, B, C, Hkv, d, dt, int8)
    grid = (f"grid ({len(pieces)},{Hkv * n_gt},{B}), clusters of {len(pieces)}, "
            f"row 0's {sum(n for _, n in pieces)} valid slots in pieces of "
            f"{pieces[0][1]}, {n_gt} group tile(s) of {gt} heads, "
            f"{res['smem_bytes']} B shared a block, {res['blocks_per_sm']} "
            f"blocks an SM, {res['clusters_resident']} clusters at once")
    where = "full ring" if full else f"pos {int(pos.min())}-{int(pos.max())}"
    lib_ms = lib_us = plain_ms = None
    if int8:
        # q read and out written in bf16, one byte a code, es bytes a scale
        nb = 2 * q.numel() * es + 2 * valid * Hkv * (d + es) + pos.numel() * 4
        run = lambda: ops.decode_attention_int8(q, k, v, ks, vs, pos)  # noqa: E731
        ref = lambda: decode_attention_int8_plain(q, k, v, ks, vs, pos)  # noqa: E731
        shape = (f"q ({B},{Hq},{d}) bf16, int8 cache ({B},{C},{Hkv * d}) + bf16 "
                 f"scales ({B},{C},{Hkv}), {where}; {grid}")
    else:
        nb = (2 * q.numel() + 2 * valid * Hkv * d) * es + pos.numel() * 4
        run = lambda: ops.decode_attention(q, k, v, pos)  # noqa: E731
        ref = lambda: decode_attention_plain(q, k, v, pos)  # noqa: E731
        shape = f"q ({B},{Hq},{d}), cache ({B},{C},{Hkv * d}) bf16, {where}; {grid}"
        if plain:
            kk, vv, qq = k.contiguous(), v.contiguous(), q[:, :, None]
            mask = torch.ones((B, 1, 1, C), dtype=torch.bool, device="cuda")
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qq, kk, vv, attn_mask=mask, enable_gqa=True)
            lib_ms, lib_us = time_ms(sdpa), all_device_us(sdpa)
    if plain:
        plain_ms = time_ms(ref)
    b, by = bound_ms(nb, 4 * valid * Hq * d, dt)
    needle = "decode_int8_kernel" if int8 else "decode_kernel"
    return dict(shape=shape, ms=time_ms(run), plain_ms=plain_ms,
                library_ms=lib_ms, library_device_us=lib_us,
                device_us=kernel_device_us(device_profile(run, 20)[0], needle),
                bound_ms=b, bound_by=by, **res)


def time_flash(gen, Hq, Hkv, S, d, causal=True):
    """Prefill attention in bf16 at B = 1 in the model's layouts, causal or
    unmasked: kernel, plain version, SDPA, profiled device time and the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    dt, es = torch.bfloat16, 2
    q = randn(gen, 1, S, Hq, d, dtype=dt).transpose(1, 2)
    k = randn(gen, 1, S, Hkv, d, dtype=dt).transpose(1, 2)
    v = randn(gen, 1, S, Hkv, d, dtype=dt).transpose(1, 2)
    pairs = S * (S + 1) // 2 if causal else S * S
    nb = (2 * Hq + 2 * Hkv) * S * d * es
    b, by = bound_ms(nb, 4 * pairs * Hq * d, dt)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qc, kc, vc, is_causal=causal, enable_gqa=True)
    run = lambda: ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
    return dict(
        shape=f"q (1,{Hq},{S},{d}), k/v (1,{Hkv},{S},{d}) bf16, "
              + ("causal" if causal else "unmasked"),
        ms=time_ms(run),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, causal=causal)),
        library_ms=time_ms(sdpa), library_device_us=all_device_us(sdpa),
        device_us=kernel_device_us(device_profile(run, 20)[0], "flash_kernel"),
        bound_ms=b, bound_by=by)


def time_rope(gen):
    """The rope kernel at ROPE_SHAPES in bf16: a decode step's q and k with
    the ring write of k and v, and a prefill's q and k. Bytes: q and k (and
    v at a step) read once and written once, pos read. No single PyTorch
    call ropes: no library time; the launch API calls a call makes are the
    kernel's and the plain version's."""
    dt, es, rows = torch.bfloat16, 2, {}
    for name, B, S, Hq, KV, hd, C, theta in ROPE_SHAPES:
        run, plain = rope_case(gen, dt, B, S, Hq, KV, hd, C, theta)
        n = B * S * (Hq + KV) * hd
        nb = 2 * (n + (B * KV * hd if C else 0)) * es + 4 * (B if C else S)
        b, by = bound_ms(nb, 3 * n, torch.float32)
        per_call, launches = device_profile(run, 20)
        key = "rope" if name == "granite decode" else "rope_" + name.replace(" ", "_")
        rows[key] = dict(
            shape=(f"q ({B},{S},{Hq},{hd}), k ({B},{S},{KV},{hd}) bf16"
                   + (f", rings ({B},{C},{KV * hd}) written at pos % C" if C else
                      ", positions arange(S)")),
            ms=time_ms(run), plain_ms=time_ms(plain),
            library_ms=None, library_device_us=None,
            device_us=kernel_device_us(per_call, "rope_kernel"),
            bound_ms=b, bound_by=by, launch_api_calls=launches,
            plain_launch_api_calls=device_profile(plain, 5)[1])
        log(f"  rope {name}: launch API calls a call, kernel {launches:.0f}, "
            f"plain {rows[key]['plain_launch_api_calls']:.0f}")
    return rows


def time_kernels():
    """Kernel / plain / library times at the main paths' shapes (bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    from repro_torch.kernels.rwkv_wkv import wkv_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    dt, es = torch.bfloat16, 2
    rows = {}

    # rmsnorm at a decode step: (B=4, 1, 768)
    x = randn(gen, 4, 1, 768, dtype=dt)
    g = randn(gen, 768, dtype=dt)
    nb = (2 * x.numel() + g.numel()) * es
    b, by = bound_ms(nb, 4 * x.numel(), torch.float32)
    rows["rmsnorm"] = dict(
        shape="x (4,1,768) bf16",
        ms=time_ms(lambda: ops.rmsnorm(x, g)),
        plain_ms=time_ms(lambda: rmsnorm_plain(x, g)),
        library_ms=time_ms(lambda: F.rms_norm(x, (768,), g, 1e-5)),
        library_device_us=all_device_us(lambda: F.rms_norm(x, (768,), g, 1e-5)),
        device_us=kernel_device_us(device_profile(
            lambda: ops.rmsnorm(x, g), 20)[0], "rmsnorm_kernel"),
        bound_ms=b, bound_by=by)

    # decode attention at a decode step: B=4, C=512, a full ring (pos > C),
    # at each served config's heads; the int8 variant at dcache's and
    # qwen3-4b's (no single PyTorch call dequantizes and attends: no
    # library time)
    for key, Hq, Hkv, d in (("decode_attention", 12, 4, 64),
                            ("decode_attention_qwen3", 32, 8, 128),
                            ("decode_attention_phi3", 32, 32, 96),
                            ("decode_attention_qwen1.5", 40, 40, 128),
                            ("decode_attention_mixtral", 48, 8, 128),
                            ("decode_attention_llama4", 40, 8, 128),
                            ("decode_attention_llava", 56, 8, 128),
                            ("decode_attention_seamless", 16, 16, 64)):
        rows[key] = time_decode(gen, 4, Hq, Hkv, 512, d)
    # seamless's cross-attention at a decode step: the encoder's 256 slots,
    # pos = 255 (every slot kept)
    rows["decode_attention_cross_seamless"] = time_decode(
        gen, 4, 16, 16, ENC_FRAMES, 64, pos=[ENC_FRAMES - 1] * 4)
    for key, Hq, Hkv, d in (("decode_attention_int8", 12, 4, 64),
                            ("decode_attention_int8_qwen3", 32, 8, 128)):
        rows[key] = time_decode(gen, 4, Hq, Hkv, 512, d, int8=True)
    # groups cut into tiles (no served config has one): G 40 at d 128 and
    # G 64 (MQA) at d 64, two tiles each, so the ring is read twice
    rows["decode_attention_g40_d128"] = time_decode(gen, 4, 40, 1, 512, 128)
    rows["decode_attention_g64_d64"] = time_decode(gen, 4, 64, 1, 512, 64)
    rows["decode_attention_int8_g64_d64"] = time_decode(gen, 4, 64, 1, 512, 64,
                                                        int8=True)
    # the benchmark cells' decode steps (SERVED_DECODE), each row at its own
    # position, a ragged mixtral-decide batch and the int8 kernel there
    for name, B, Hq, Hkv, d, C, lo, hi in SERVED_DECODE:
        key = "decode_attention_served_" + name.replace(" ", "_")
        rows[key] = time_decode(gen, B, Hq, Hkv, C, d,
                                pos=served_pos(gen, B, C, lo, hi), plain=False)
        if name == "mixtral decide":
            rows[key + "_ragged"] = time_decode(
                gen, B, Hq, Hkv, C, d, pos=served_pos(gen, B, C, lo, hi, True),
                plain=False)
            rows[key + "_int8"] = time_decode(
                gen, B, Hq, Hkv, C, d, int8=True, pos=served_pos(gen, B, C, lo, hi),
                plain=False)
        torch.cuda.empty_cache()

    # prefill attention at the commonest prompt bucket (B=1, S=64, causal)
    # and at the engine's max_len (S=512), at each served config's heads
    for key, Hq, Hkv, d in (("flash_attention", 12, 4, 64),
                            ("flash_attention_qwen3", 32, 8, 128),
                            ("flash_attention_phi3", 32, 32, 96),
                            ("flash_attention_mixtral", 48, 8, 128),
                            ("flash_attention_llama4", 40, 8, 128),
                            ("flash_attention_llava", 56, 8, 128)):
        for S in (64, 512):
            rows[key + ("_s512" if S == 512 else "")] = time_flash(
                gen, Hq, Hkv, S, d)
    # llava's image prefill (patches + text) and seamless's encoder over
    # its frames, unmasked
    rows["flash_attention_llava_image"] = time_flash(
        gen, 56, 8, 2880 + IMAGE_TEXT, 128)
    rows["flash_attention_seamless_encoder"] = time_flash(
        gen, 16, 16, ENC_FRAMES, 64, causal=False)
    # head dims 16 and 32 at the reduced dcache-agent-150m's heads (4 q over
    # 2 KV) and the serving bench's shapes (max_batch 4, max_len 128):
    # a prompt bucket of 32, a ring of 128 slots
    for d in (16, 32):
        rows[f"flash_attention_d{d}"] = time_flash(gen, 4, 2, 32, d)
        rows[f"decode_attention_d{d}"] = time_decode(gen, 4, 4, 2, 128, d)
        rows[f"decode_attention_int8_d{d}"] = time_decode(gen, 4, 4, 2, 128, d,
                                                          int8=True)

    # rmsnorm at the rwkv6-7b decode step's shapes: norm1/norm2 (4,1,4096)
    # and the per-head ln_x norm, 4*64 rows of 64; and the reduced rwkv6's
    # ln_x norm, 4*4 rows of 16
    for key, shp in (("rmsnorm_d4096", (4, 1, 4096)),
                     ("rmsnorm_heads64", (4, 1, 64, 64)),
                     ("rmsnorm_heads16", (4, 1, 4, 16))):
        x = randn(gen, *shp, dtype=dt)
        g = randn(gen, shp[-1], dtype=dt)
        b, by = bound_ms((2 * x.numel() + g.numel()) * es, 4 * x.numel(),
                         torch.float32)
        rows[key] = dict(
            shape=f"x {shp} bf16",
            ms=time_ms(lambda: ops.rmsnorm(x, g)),
            plain_ms=time_ms(lambda: rmsnorm_plain(x, g)),
            library_ms=time_ms(lambda: F.rms_norm(x, (shp[-1],), g, 1e-5)),
            library_device_us=all_device_us(
                lambda: F.rms_norm(x, (shp[-1],), g, 1e-5)),
            device_us=kernel_device_us(device_profile(
                lambda: ops.rmsnorm(x, g), 20)[0], "rmsnorm_kernel"),
            bound_ms=b, bound_by=by)

    # WKV at the rwkv6-7b decode step (B=4, S=1, the cache's state updated
    # in place) and at a prefill (B=1, S=48, zero state); at head dim 16
    # the reduced rwkv6's 4 heads (its smoke main's shapes), at 32 8 heads.
    # No single PyTorch call computes this recurrence, so there is no
    # library time.
    for key, hd, H, B, S in (("wkv", 64, 64, 4, 1), ("wkv_prefill", 64, 64, 1, 48),
                             ("wkv_prefill_s512", 64, 64, 1, 512),
                             ("wkv_hd16", 16, 4, 4, 1), ("wkv_prefill_hd16", 16, 4, 1, 48),
                             ("wkv_hd32", 32, 8, 4, 1), ("wkv_prefill_hd32", 32, 8, 1, 48)):
        r, k, v, w, u = wkv_inputs(gen, B, S, H, hd, dt)
        r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
        state = torch.randn((B, H, hd, hd), generator=gen, device="cuda") \
            if S == 1 else None
        n = B * S * H * hd
        nb = 4 * n * es + 4 * n + H * hd * es \
            + (2 if state is not None else 1) * B * H * hd * hd * 4
        b, by = bound_ms(nb, 7 * n * hd, torch.float32)
        run = lambda: ops.wkv(r, k, v, w, u, s0=state, state_out=state)  # noqa: E731
        rows[key] = dict(
            shape=f"r/k/v ({B},{S},{H},{hd}) bf16, w fp32, "
                  + ("state in place" if state is not None else "zero state"),
            ms=time_ms(run),
            plain_ms=time_ms(lambda: wkv_plain(r, k, v, w, u, state)),
            library_ms=None, library_device_us=None,
            device_us=kernel_device_us(device_profile(run, 20)[0], "wkv_kernel"),
            bound_ms=b, bound_by=by)
    rows.update(time_rope(gen))
    # the floor under any launch: an empty kernel of one 128-thread block
    from repro_torch.kernels import _build
    clib, stream = _build.load_library(), torch.cuda.current_stream().cuda_stream
    empty = lambda: _build.check(clib.repro_empty(stream), "empty")  # noqa: E731
    rows["empty_kernel"] = dict(
        shape="<<<1, 128>>>, no work", ms=time_ms(empty), plain_ms=0.0,
        library_ms=None, library_device_us=None,
        device_us=kernel_device_us(device_profile(empty, 20)[0], "empty_kernel"),
        bound_ms=0.0, bound_by="bytes")
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else (
            f"{r['library_ms']:.4f} ms (device {r['library_device_us']:.2f} us)")
        plain = "not timed" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
        log(f"  time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{plain}, library {lib}, device "
            f"(profiler) {r['device_us']:.2f} us, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------


def expected_launches(cfg, prefills, steps):
    """Kernel launches the serving path implies: the dense decoder runs
    rmsnorm twice a layer (four times with qk_norm: q and k too) and once
    at the end, flash attention per layer at each prefill and decode
    attention per layer at each step; rwkv6 runs rmsnorm three times a
    layer (norm1, norm2, the per-head ln_x norm) and once at the end, and
    the WKV kernel per layer at every prefill and step. With kv_quant every
    decode attention launch is the int8 kernel's. The encoder-decoder adds
    to each prefill its encoder's Le layers (rmsnorm twice a layer and once
    at the end, flash unmasked once a layer) and to every decoder layer a
    third rmsnorm and the cross-attention: torch ops at a prefill, the
    decode kernel at a step. The vlm family takes the dense rule, an image
    prefill included. Every roped self-attention layer launches the rope
    kernel once a prefill and once a step (with the ring write at a step;
    the int8 ring's rope alone): L per prefill and per step, plus the
    encoder's Le per prefill; rwkv6 has no rope."""
    L, n = cfg.n_layers, prefills + steps
    if cfg.family == "ssm":
        return {"rmsnorm": (3 * L + 1) * n, "flash_attention": 0,
                "decode_attention": 0, "decode_attention_int8": 0, "wkv": L * n,
                "rope": 0}
    if cfg.is_encdec:
        Le = cfg.n_encoder_layers
        return {"rmsnorm": (2 * Le + 1) * prefills + (3 * L + 1) * n,
                "flash_attention": (Le + L) * prefills,
                "decode_attention": 2 * L * steps, "decode_attention_int8": 0,
                "wkv": 0, "rope": Le * prefills + L * n}
    decode = "decode_attention_int8" if cfg.kv_quant else "decode_attention"
    norms = 4 if cfg.qk_norm else 2
    out = {"rmsnorm": (norms * L + 1) * n, "flash_attention": L * prefills,
           "decode_attention": 0, "decode_attention_int8": 0, "wkv": 0,
           "rope": L * n}
    out[decode] = L * steps
    return out


def cache_bytes(cache):
    return sum(t.numel() * t.element_size() for k, t in cache.items() if k != "pos")


def serve_bytes(cfg, max_batch=4, max_len=512):
    """The bytes of ``cfg``'s weights and serving cache on the card (the
    engine's own cache leaves, allocated on the meta device)."""
    from repro_torch.configs import alloc_cache
    from repro_torch.launch.serve import weight_bytes

    return weight_bytes(cfg) + cache_bytes(
        alloc_cache(cfg, max_batch, max_len, torch.device("meta")))


def load_path(arch, kv_quant=False, n_layers=None, extra_bytes=0):
    """``arch`` (depth cut to ``n_layers`` if given) with seeded random bf16
    weights on the card, after asserting that they, the engine's cache and
    ``extra_bytes`` fit its free memory. Returns (cfg, params, generator,
    record)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model

    full = get_config(arch)
    cfg = dataclasses.replace(full, kv_quant=kv_quant,
                              n_layers=n_layers or full.n_layers)
    free, need = torch.cuda.mem_get_info()[0], serve_bytes(cfg) + extra_bytes
    assert need < free, (f"{arch}: weights and cache at {cfg.n_layers} layers "
                         f"need {need / 2**30:.2f} GiB, {free / 2**30:.2f} GiB free")
    cut = ("full depth" if cfg.n_layers == full.n_layers else
           f"depth cut from {full.n_layers} layers, width unchanged")
    log(f"  {arch}: weights, cache and requests {need / 2**30:.2f} GiB of "
        f"{free / 2**30:.2f} GiB free on the card at {cfg.n_layers} layers "
        f"({cut})")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(cfg, gen, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.name}: {n_params / 1e6:.1f} M params summed from the tensors "
        f"({cfg.param_count() / 1e6:.1f} M by ModelConfig.param_count), "
        f"{cfg.dtype}, L={cfg.n_layers} d={cfg.d_model}, family {cfg.family}")
    return cfg, params, gen, dict(params=n_params, n_layers=cfg.n_layers,
                                  full_layers=full.n_layers)


def check_unembed(cfg, params, gen):
    """The unembed at a decode step: the bf16 GEMM with fp32 output against
    an fp32 copy of the weight (same accumulation, extra traffic)."""
    from repro_torch.models.model import _unembed

    h = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda").to(cfg.torch_dtype)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    V = cfg.vocab_size
    err = (_unembed(cfg, params, h)[..., :V]
           - (h.float() @ w.float())[..., :V]).abs().max().item()
    log(f"  unembed (4,1,{cfg.d_model}) x ({cfg.d_model},{cfg.padded_vocab}): "
        f"max |diff| from the fp32 product {err:.3e} <= 1e-3")
    assert err <= 1e-3, f"unembed differs from the fp32 product by {err:.3e}"


def image_ring_bytes(cfg):
    """What llava's image request holds on the card beyond the weights: its
    ring of IMAGE_MAX_LEN slots twice (the layers' rings and their stack)."""
    from repro_torch.configs import alloc_cache

    return 2 * cache_bytes(alloc_cache(cfg, 1, IMAGE_MAX_LEN, torch.device("meta")))


def serve_workload(eng, n_new=32):
    """Phase 3's workload on ``eng``: the 8 PROMPTS of ``n_new`` tokens
    each, served to completion."""
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in PROMPTS]
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step()
    assert all(r.done and 1 <= len(r.out_ids) <= n_new for r in reqs), "unfinished"


def serve_full_width(arch, kv_quant=False, n_layers=None):
    """``arch`` at full width (depth cut to ``n_layers`` if given) through
    ServingEngine(max_batch=4, max_len=512): the 8 PROMPTS of 32 new tokens
    and one TorchLLM.complete with exact launch counts, then the unembed;
    llava then serves its image request (``image_request``)."""
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine

    full = get_config(arch)
    vlm = full.frontend == "vision_patches"
    cfg, params, gen, m = load_path(arch, kv_quant, n_layers, extra_bytes=(
        image_ring_bytes(full) if vlm else 0))
    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    if kv_quant:
        assert eng.cache["k"].dtype == torch.int8 and "k_scale" in eng.cache
    with counting_launches() as counts:
        serve_workload(eng)
        text = TorchLLM(eng, max_new_tokens=32).complete(PROMPTS[1])
        torch.cuda.synchronize()

    assert eng.finished[-1].done, "unfinished"
    assert all(0 <= t < cfg.vocab_size for r in eng.finished for t in r.out_ids)
    assert isinstance(text, str)
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    log(f"  prefills={eng.prefills} decode_steps={eng.steps} "
        f"launches={counts} expected={expected}; TorchLLM -> {text!r}")
    assert counts == expected, "launch counts differ from the main path's"
    m.update(prefills=eng.prefills, steps=eng.steps, launches=counts)
    check_unembed(cfg, params, gen)
    if vlm:
        del eng
        free_card()
        c = image_request(cfg, params, gen)
        counts = {k: counts[k] + c[k] for k in counts}
    return counts, m


def image_request(cfg, params, gen):
    """llava's image request: 2,880 patch embeddings before a 32-token
    prompt through prefill_step (B 1, a ring of 4,096 slots) and 32 greedy
    decode_steps, with the dense rule's launch counts."""
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.serving.tokenizer import ByteTokenizer

    free, need = torch.cuda.mem_get_info()[0], image_ring_bytes(cfg)
    assert need < free, (f"image request needs {need / 2**30:.2f} GiB, "
                         f"{free / 2**30:.2f} GiB free")
    P = cfg.n_frontend_tokens
    ids = ByteTokenizer().encode(PROMPTS[2])[:IMAGE_TEXT]
    batch = {"tokens": torch.tensor([ids], dtype=torch.int32, device="cuda"),
             "patches": torch.randn((1, P, cfg.d_model), generator=gen,
                                    device="cuda").to(cfg.torch_dtype)}
    with counting_launches() as counts:
        cache, logits = prefill_step(cfg, params, batch, max_len=IMAGE_MAX_LEN)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out = [int(nxt)]
        for _ in range(32):
            logits, cache = decode_step(cfg, params, nxt, cache)
            nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(int(nxt))
    expected = expected_launches(cfg, 1, 32)
    S = P + len(ids)
    assert int(cache["pos"][0]) == S + 32, cache["pos"]
    assert tuple(cache["k"].shape) == (cfg.n_layers, 1, IMAGE_MAX_LEN,
                                       cfg.n_kv_heads * cfg.head_dim_)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    assert all(0 <= t < cfg.vocab_size for t in out)
    log(f"  image request: {P} patches + {len(ids)} tokens (S {S}) in a ring "
        f"of {IMAGE_MAX_LEN}, 32 decode steps; launches={counts} "
        f"expected={expected}")
    assert counts == expected, "image request's launch counts differ"
    return counts


def serve_encdec(arch):
    """seamless at full width: 4 requests of 256 frames and a 16-32 token
    decoder prompt each through ``launch.serve.generate_encdec``
    (prefill_step with a ring of 512, then 32 greedy decode_steps) with
    exact launch counts, then the unembed."""
    from repro_torch.launch.serve import generate_encdec
    from repro_torch.serving.tokenizer import ByteTokenizer

    cfg, params, gen, m = load_path(arch)
    tok = ByteTokenizer()
    ids = [tok.encode(PROMPTS[i])[:n] for i, n in zip((0, 2, 4, 5),
                                                      (16, 21, 26, 32))]
    frames = torch.randn((4, ENC_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.torch_dtype)
    with counting_launches() as counts:
        out = generate_encdec(cfg, params, ids, frames, 512, 32)
        torch.cuda.synchronize()
    expected = expected_launches(cfg, 1, 32)
    assert tuple(out.shape) == (4, 33)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    log(f"  4 requests ({[len(i) for i in ids]} tokens, {ENC_FRAMES} frames "
        f"each) + 32 greedy steps; first row -> {tok.decode(out[0].tolist())!r}; "
        f"launches={counts} expected={expected}")
    assert counts == expected, "launch counts differ from the main path's"
    m.update(prefills=1, steps=32, launches=counts)
    check_unembed(cfg, params, gen)
    return counts, m


# ---------------------------------------------------------------------------
# phase 4: CPU (plain versions) against the card (kernels), fp32
# ---------------------------------------------------------------------------

def tree_to(p, device):
    if isinstance(p, dict):
        return {k: tree_to(v, device) for k, v in p.items()}
    if isinstance(p, list):
        return [tree_to(v, device) for v in p]
    return p.to(device)


def prefill(cfg, params, ids, device, extra=None):
    """Prefill the prompts ``ids`` on ``device``: attention prompts
    right-padded into one batch with true_lens, beside the batch entries of
    ``extra`` (frames or patches, moved to ``device``); rwkv and hymba
    prompts, and prompts longer than a window's or chunk's ring (which the
    engine prefills at their exact length too), one by one at their own
    length, their caches then joined along the batch dimension."""
    from repro_torch.configs import effective_cache_len
    from repro_torch.models.model import prefill_step

    padded_fits = effective_cache_len(cfg, 64) >= max(len(i) for i in ids)
    if cfg.family not in ("ssm", "hybrid") and padded_fits:
        S = max(len(i) for i in ids)
        batch = {k: v.to(device) for k, v in (extra or {}).items()}
        batch["tokens"] = torch.tensor([i + [0] * (S - len(i)) for i in ids],
                                       dtype=torch.int32, device=device)
        lens = torch.tensor([len(i) for i in ids], dtype=torch.int32,
                            device=device)
        n_patches = batch["patches"].shape[1] if "patches" in batch else 0
        return prefill_step(cfg, params, batch, max_len=64 + n_patches,
                            true_lens=lens)
    assert not extra, "frames or patches take the padded batch"
    rows = [prefill_step(cfg, params, {"tokens": torch.tensor(
        [i], dtype=torch.int32, device=device)}, max_len=64) for i in ids]
    cache = {k: torch.cat([c[k] for c, _ in rows], dim=0 if k == "pos" else 1)
             for k in rows[0][0]}
    return cache, torch.cat([lg for _, lg in rows])


def cpu_vs_card(arch, tol=1e-3, kv_quant=False, reduced=False):
    """``arch`` at full width cut to 2 layers, or its reduced config (head
    dim 16, vocab 512 for the byte tokenizer), at fp32 on the CPU and on
    the card: prefill and 8 greedy decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_model
    from repro_torch.serving.tokenizer import ByteTokenizer

    cfg = (dataclasses.replace(get_config(arch).reduced(), vocab_size=512)
           if reduced else dataclasses.replace(get_config(arch), n_layers=2))
    cfg = dataclasses.replace(cfg, dtype="float32", kv_quant=kv_quant)
    # drawn on the card (fast) and copied to the CPU
    gen = torch.Generator(device="cuda").manual_seed(1)
    gpu_params = init_model(cfg, gen, "cuda")
    # QKV biases and the SSM heads' dt bias and decay start at zero, as in
    # JAX, which would hold nothing: noise
    for lp in gpu_params["layers"]:
        for part, b in (("attn", "bq"), ("attn", "bk"), ("attn", "bv"),
                        ("ssm", "b_dt"), ("ssm", "a_log")):
            if b in lp.get(part, {}):
                lp[part][b].normal_(0.0, 0.5, generator=gen)
    cpu_params = tree_to(gpu_params, "cpu")
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in PROMPTS[:3]]
    # seamless: 64 frames a prompt; llava: 16 patches before each prompt
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = torch.randn((3, 64, cfg.d_model), generator=gen,
                                      device="cuda").cpu()
    elif cfg.frontend == "vision_patches":
        extra["patches"] = torch.randn((3, 16, cfg.d_model), generator=gen,
                                       device="cuda").cpu()
    c_cache, c_log = prefill(cfg, cpu_params, ids, "cpu", extra)
    g_cache, g_log = prefill(cfg, gpu_params, ids, "cuda", extra)
    worst, near_ties = 0.0, 0
    for step in range(9):
        cl, gl = c_log[:, -1], g_log[:, -1].cpu()
        real = slice(0, cfg.vocab_size)
        err = (cl[:, real] - gl[:, real]).abs().max().item()
        worst = max(worst, err)
        assert err <= tol, f"step {step}: logits differ by {err:.3e} > {tol}"
        ct, gt = cl.argmax(-1), gl.argmax(-1)
        for b in torch.nonzero(ct != gt).flatten().tolist():
            top2 = cl[b].topk(2).values
            gap = (top2[0] - top2[1]).item()
            assert gap <= tol, f"step {step} row {b}: tokens differ, gap {gap:.3e}"
            near_ties += 1
            log(f"  step {step} row {b}: greedy tokens differ on a near tie "
                f"(top-2 gap {gap:.3e} <= {tol}); the CPU's token is fed to both")
        if step == 8:
            break
        nxt = ct[:, None].to(torch.int32)      # teacher-force the CPU's tokens
        c_log, c_cache = decode_step(cfg, cpu_params, nxt, c_cache)
        g_log, g_cache = decode_step(cfg, gpu_params, nxt.cuda(), g_cache)
    flips = 0
    for k in c_cache:
        diff = (c_cache[k].float() - g_cache[k].float().cpu()).abs()
        if c_cache[k].dtype == torch.int8:
            # a value on a rounding edge may round one way on each side
            assert diff.max().item() <= 1, f"int8 cache {k} differs by > 1 code"
            flips += int((diff > 0).sum())
            continue
        assert diff.max().item() <= tol, f"cache {k} differs by {diff.max():.3e} > {tol}"
    name = arch + (" kv_quant" if kv_quant else "")
    size = ("reduced, head dim 16" if reduced else "2 layers, full width")
    log(f"  {name} cpu vs card fp32 ({size}, 3 prompts, prefill "
        f"+ 8 decode steps): max |logit diff| {worst:.3e} <= {tol}; "
        f"differing greedy tokens: {near_ties}"
        + (f"; int8 codes off by one: {flips} of "
           f"{c_cache['k'].numel() + c_cache['v'].numel()}" if kv_quant else ""))
    return worst, near_ties, flips


# phase 4's reduced configs (head dim 16, vocab 512): every family
REDUCED_ARCHS = ("dcache-agent-150m", "rwkv6-7b", "qwen3-4b", "granite-3-2b",
                 "phi3-mini-3.8b", "qwen1.5-32b", "mixtral-8x22b",
                 "llama4-maverick-400b-a17b", "hymba-1.5b",
                 "seamless-m4t-large-v2", "llava-next-34b")


# ---------------------------------------------------------------------------
# the paged KV cache on the card
# ---------------------------------------------------------------------------

def paged_phase():
    """A full-width PagedKVCache for dcache-agent-150m (L 12, kv_dim 256,
    pages of 16, 256 pages, bf16) filled with the K/V of the card's own
    prefill and decode steps (ServingEngine, 8 prompts, 4 steps): each
    prompt by write_prompt, each decoded token by append. gather must give
    each sequence's slots of the engine's ring bit for bit; fork_seq shares
    full pages and copies the tail; paged_decode_attention on the card must
    equal its plain version on the CPU (bf16 tolerance) at lengths 1, 15,
    16, 17 and the sequences' own (multi-page) lengths. Launch counts are
    exact. A zero-length row (no caller makes one) is recorded, not held."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.kv_cache import (PagedCacheConfig, PagedKVCache,
                                              paged_decode_attention)

    cfg = get_config("dcache-agent-150m")
    KV, hd = cfg.n_kv_heads, cfg.head_dim_
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    pc = PagedKVCache(PagedCacheConfig(n_layers=cfg.n_layers, kv_dim=KV * hd,
                                       page_size=16, n_pages=256,
                                       dtype=cfg.dtype), device="cuda")
    with counting_launches() as counts:
        eng = ServingEngine(cfg, params, max_batch=8, max_len=512, device="cuda")
        reqs = [eng.submit(p, max_new_tokens=32) for p in PROMPTS]
        eng.step()                         # admits all 8, then one decode step
        ring_k, ring_v = eng.cache["k"], eng.cache["v"]    # (L, 8, 512, 256)
        sids = []
        for b, r in enumerate(reqs):
            n, p = len(r.prompt_ids), int(eng.cache["pos"][b])
            sid = pc.new_seq()
            pc.write_prompt(sid, ring_k[:, b, :n], ring_v[:, b, :n])
            for j in range(n, p):          # the decoded token(s)
                pc.append(sid, ring_k[:, b, j], ring_v[:, b, j])
            sids.append(sid)
        for _ in range(3):
            before = eng.cache["pos"].tolist()
            eng.step()                     # slot pos % C gets the new token
            for b, sid in enumerate(sids):
                pc.append(sid, ring_k[:, b, before[b]], ring_v[:, b, before[b]])
        k, v, lengths = pc.gather(sids)
        pos = eng.cache["pos"]
        assert torch.equal(lengths.cpu(), pos.cpu()), (lengths, pos)
        for b in range(len(sids)):
            n = int(lengths[b])
            assert torch.equal(k[:, b, :n], ring_k[:, b, :n]), f"gather k row {b}"
            assert torch.equal(v[:, b, :n], ring_v[:, b, :n]), f"gather v row {b}"
        used = pc.cfg.n_pages - pc.alloc.n_free
        log(f"  paged: 8 sequences of {lengths.tolist()} tokens in {used} pages "
            f"(utilization {pc.utilization():.3f}); gather equals the engine's "
            f"ring bit for bit")

        # prefix sharing: the longest sequence, whose last page is partial
        a = sids[int(torch.argmax(lengths))]
        la = pc.seqs[a].length
        full = la // 16
        f = pc.fork_seq(a)
        assert pc.seqs[f].pages[:full] == pc.seqs[a].pages[:full]
        assert all(pc.alloc.refs[p] == 2 for p in pc.seqs[a].pages[:full])
        assert pc.seqs[f].pages[full] != pc.seqs[a].pages[full]
        kf, vf, _ = pc.gather([f])
        ka, va, _ = pc.gather([a])
        assert torch.equal(kf[:, :, :la], ka[:, :, :la])
        assert torch.equal(vf[:, :, :la], va[:, :, :la])
        tok = torch.randn((cfg.n_layers, KV * hd), device="cuda").to(cfg.torch_dtype)
        pc.append(f, tok, tok)
        ka2, _, _ = pc.gather([a])
        assert torch.equal(ka2[:, :, :la], ka[:, :, :la]), "a fork's append moved its parent"
        pc.free_seq(f)
        assert pc.cfg.n_pages - pc.alloc.n_free == used
        log(f"  paged: fork of a {la}-token sequence shares {full} pages and "
            f"copies its tail; an append to the fork leaves the parent as it was; "
            f"freeing the fork returns its page")

        # attention over pages: card (kernel) against CPU (plain), layer 0
        errs, n_attn = [], 0
        gen = torch.Generator(device="cuda").manual_seed(3)
        longest = int(torch.argmax(lengths))
        extra = []
        for n in (1, 15, 16, 17):          # prefixes of the longest sequence
            sid = pc.new_seq()
            pc.write_prompt(sid, ring_k[:, longest, :n], ring_v[:, longest, :n])
            extra.append(sid)
        for name, batch in (("lengths 1, 15, 16, 17", extra),
                            ("the 8 sequences", sids)):
            k, v, lens = pc.gather(batch)
            q = randn(gen, len(batch), cfg.n_heads * hd, dtype=cfg.torch_dtype)
            out = paged_decode_attention(q, k[0], v[0], lens, KV, hd)
            n_attn += 1
            ref = paged_decode_attention(q.cpu(), k[0].cpu(), v[0].cpu(),
                                         lens.cpu(), KV, hd)
            err = (out.float().cpu() - ref.float()).abs().max().item()
            ok = torch.allclose(out.float().cpu(), ref.float(), atol=TOL[cfg.torch_dtype],
                                rtol=TOL[cfg.torch_dtype])
            log(f"  paged_decode_attention {name} (lengths {lens.tolist()}): card "
                f"vs plain max_abs_err={err:.3e} tol={TOL[cfg.torch_dtype]:g} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok and out.dtype == q.dtype, f"paged attention {name} disagrees"
            errs.append(err)
        # a zero-length row: recorded only (JAX and the plain version return
        # the mean of the gathered junk; the kernel's all-masked row differs)
        z = pc.new_seq()
        k, v, lens = pc.gather([extra[0], z])
        q = randn(gen, 2, cfg.n_heads * hd, dtype=cfg.torch_dtype)
        out = paged_decode_attention(q, k[0], v[0], lens, KV, hd)
        n_attn += 1
        ref = paged_decode_attention(q.cpu(), k[0].cpu(), v[0].cpu(), lens.cpu(), KV, hd)
        zero_row = dict(card_max_abs=out[1].float().abs().max().item(),
                        plain_max_abs=ref[1].float().abs().max().item(),
                        diff=(out[1].float().cpu() - ref[1].float()).abs().max().item())
        log(f"  paged_decode_attention zero-length row (recorded, not held): card "
            f"max |out| {zero_row['card_max_abs']:.4e}, plain max |out| "
            f"{zero_row['plain_max_abs']:.4e}, diff {zero_row['diff']:.4e}")
        torch.cuda.synchronize()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    expected["decode_attention"] += n_attn
    log(f"  paged phase launches={counts} expected={expected}")
    assert counts == expected, "paged phase launch counts differ"
    return counts, dict(lengths=lengths.tolist(), pages_used=used,
                        max_abs_err=max(errs), zero_length_row=zero_row,
                        attention_launches=n_attn)


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# assigned shapes: decode_32k and prefill_32k on full-width dcache-agent-150m
# ---------------------------------------------------------------------------

def spec_bytes(tree):
    """The bytes of a tree of (meta) tensors."""
    if isinstance(tree, dict):
        return sum(spec_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def assert_fits(what, nbytes):
    free = torch.cuda.mem_get_info()[0]
    assert nbytes < free, (f"{what}: needs {nbytes / 2**30:.2f} GiB, "
                           f"{free / 2**30:.2f} GiB free")
    log(f"  {what}: {nbytes / 2**30:.2f} GiB of {free / 2**30:.2f} GiB free")


def decode_32k(cfg, params, gen, m):
    """decode_32k: B 128 over a ring of 32,768 slots, every slot valid (pos
    past the ring's end), the ring drawn from ``gen`` layer by layer. One
    decode_step, then one profiled (the decode kernel's device time and
    its bound, the whole ring read once); then one layer's decode
    attention at this size against its plain version, 16 rows at a
    time."""
    from repro_torch.configs import DECODE_32K, input_specs
    from repro_torch.models.model import decode_step

    shape = DECODE_32K
    B, S, L = shape.global_batch, shape.seq_len, cfg.n_layers
    specs = input_specs(cfg, shape)
    assert_fits("decode_32k inputs (tokens and the ring)", spec_bytes(specs))
    cache = {}
    for k, t in specs["cache"].items():
        cache[k] = torch.empty(t.shape, dtype=t.dtype, device="cuda")
        if k == "pos":    # 100 to 227 tokens past the ring's end: all valid
            cache[k].copy_(torch.arange(S + 100, S + 100 + B, dtype=torch.int32))
        else:
            for layer in cache[k]:
                layer.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, tuple(specs["tokens"].shape),
                           generator=gen, device="cuda", dtype=torch.int32)
    step = lambda: decode_step(cfg, params, tokens, cache)  # noqa: E731
    with counting_launches() as counts, torch.no_grad():
        logits, _ = step()
        per_call = device_profile(step, 1, warmup=False)[0]
    expected = expected_launches(cfg, 0, 2)
    log(f"  decode_32k launches={counts} expected={expected}")
    assert counts == expected, "decode_32k launch counts differ"
    assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    dec_us = kernel_device_us(per_call, "decode_kernel") / L
    # the decode kernel's own bytes: the whole ring of a layer, q and out
    ring = 2 * B * S * cfg.n_kv_heads * cfg.head_dim_ * 2
    m["decode_32k"] = dict(B=B, C=S, decode_kernel_us=dec_us,
                           decode_kernel_bound_us=1e6 * ring / PEAK_BYTES_S,
                           launches=counts)
    log(f"  decode_32k (B {B}, ring {S}, bf16): decode kernel {dec_us:.1f} us "
        f"a launch in a profiled step (its ring read {ring / 1e9:.3f} GB: "
        f"{1e6 * ring / PEAK_BYTES_S:.1f} us at 3.35 TB/s)")
    hq, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    k = cache["k"][0].view(B, S, kvh, hd).transpose(1, 2)
    v = cache["v"][0].view(B, S, kvh, hd).transpose(1, 2)
    q = randn(gen, B, hq, hd, dtype=cfg.torch_dtype)
    m["decode_32k"]["max_row_rel_err"] = hold_decode_ring(
        q, k, v, cache["pos"], m.setdefault("errs", {}))
    return counts


def hold_decode_ring(q, k, v, pos, errs):
    """Layer 0 of decode_32k against the plain version: the kernel over all
    rows, the plain version 16 rows at a time (its fp32 copy of the ring
    would not fit at once); held absolutely and row by row relative to the
    rows' size (a dropped split-K partial shows only there). Returns the
    worst row's relative error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain

    B, C = q.shape[0], k.shape[2]
    with torch.no_grad():
        out = ops.decode_attention(q, k, v, pos)
        gold = torch.cat([decode_attention_plain(q[i:i + 16], k[i:i + 16],
                                                 v[i:i + 16], pos[i:i + 16])
                          for i in range(0, B, 16)])
    case = f"decode_32k layer 0 (B {B}, C {C})"
    compare("decode_attention", case, out, gold, q.dtype, errs)
    return compare_rows("decode_attention", case, out, gold, q.dtype).max().item()


def hold_flash_head(q, k, v, bi, h, errs):
    """One (batch row, head) of flash's causal output at full S against the
    plain version of that head alone; held absolutely and query row by
    query row relative to each row's size (late rows, which only a long
    prompt has, average over the most keys and have the smallest outputs).
    Returns the worst row's and the last 1,024 rows' worst relative error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    S, hq, kvh = q.shape[2], q.shape[1], k.shape[1]
    g = h // (hq // kvh)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)[bi:bi + 1, h:h + 1]
        gold = flash_attention_plain(q[bi:bi + 1, h:h + 1], k[bi:bi + 1, g:g + 1],
                                     v[bi:bi + 1, g:g + 1])
    case = f"prefill_32k layer 0 row {bi} head {h} (S {S})"
    compare("flash_attention", case, out, gold, q.dtype, errs)
    ratio = compare_rows("flash_attention", case, out, gold, q.dtype)
    late = ratio[-1024:].max().item()
    log(f"  flash_attention {case}: last 1,024 query rows' worst "
        f"rms(err)/rms(row)={late:.3e}")
    return ratio.max().item(), late


def prefill_32k(cfg, params, gen, m):
    """prefill_32k: B 32 x S 32,768 through prefill_step (the batch cut
    where its working set would not fit). Then flash on one layer's q
    (drawn), k and v (the prefilled cache's layer 0), timed against SDPA
    on the same inputs and its bound, and one (row, head) of its output
    held against the plain version of that head alone (a full plain
    version would need 1.6 TB of scores)."""
    import torch.nn.functional as F

    from repro_torch.configs import PREFILL_32K, alloc_cache, input_specs
    from repro_torch.kernels import ops
    from repro_torch.models.model import prefill_step

    shape = PREFILL_32K
    S, L, D, F_ = shape.seq_len, cfg.n_layers, cfg.d_model, cfg.d_ff
    es = 2

    def working_set(b):
        """Peak bytes of prefill_step: the cache's layer list and its stack
        at the end, or the last layer's list beside its FFN (up, gate,
        silu(gate), product) and three residual-width tensors."""
        kv = spec_bytes(alloc_cache(cfg, b, S, torch.device("meta")))
        mid = kv * (L - 1) / L + b * S * (4 * F_ + 3 * D) * es
        return max(mid, 2 * kv + 2 * b * S * D * es)

    B, free = shape.global_batch, torch.cuda.mem_get_info()[0]
    while 1.25 * working_set(B) > free and B > 1:
        B //= 2
    cut = B != shape.global_batch
    log(f"  prefill_32k: working set at B {B} about "
        f"{working_set(B) / 2**30:.2f} GiB (x1.25 margin) of {free / 2**30:.2f} "
        f"GiB free" + (f"; batch cut from {shape.global_batch} to {B}" if cut
                       else "; no batch cut"))
    specs = input_specs(cfg, shape)
    tokens = torch.randint(0, cfg.vocab_size, (B, specs["tokens"].shape[1]),
                           generator=gen, device="cuda", dtype=torch.int32)
    with counting_launches() as counts, torch.no_grad():
        cache, logits = prefill_step(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
    assert int(cache["pos"][0]) == S and tuple(cache["k"].shape) == (
        L, B, S, cfg.n_kv_heads * cfg.head_dim_)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    k0, v0 = cache["k"][0].clone(), cache["v"][0].clone()
    del cache, logits
    expected = expected_launches(cfg, 1, 0)
    log(f"  prefill_32k launches={counts} expected={expected}")
    assert counts == expected, "prefill_32k launch counts differ"
    # one layer's flash at this size: kernel, SDPA (the library figure)
    hq, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = randn(gen, B, S, hq, hd, dtype=cfg.torch_dtype).transpose(1, 2)
    k = k0.view(B, S, kvh, hd).transpose(1, 2)
    v = v0.view(B, S, kvh, hd).transpose(1, 2)
    with torch.no_grad():
        kern = lambda: ops.flash_attention(q, k, v)  # noqa: E731
        fl_ms = time_ms(kern, iters=3, warmup=1)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True), iters=3, warmup=1)
        del qc, kc, vc
    row_rel, late_rel = hold_flash_head(q, k, v, B - 1, hq - 1,
                                        m.setdefault("errs", {}))
    pairs = S * (S + 1) // 2
    fl_bound, fl_by = bound_ms((2 * hq + 2 * kvh) * B * S * hd * es,
                               4 * pairs * hq * hd * B, cfg.torch_dtype)
    m["prefill_32k"] = dict(
        B=B, S=S, batch_cut=cut, flash_layer_ms=fl_ms, sdpa_layer_ms=sdpa_ms,
        flash_layer_bound_ms=fl_bound, flash_layer_bound_by=fl_by,
        max_row_rel_err=row_rel, last_rows_rel_err=late_rel, launches=counts)
    log(f"  prefill_32k (B {B} x S {S}, bf16): one layer's flash {fl_ms:.2f} ms, "
        f"SDPA {sdpa_ms:.2f} ms, bound {fl_bound:.2f} ms ({fl_by})")
    return counts


TRAIN4K_FIRST_ACCUM = 32   # micro-batches of 8 x 4,096: the first try
TRAIN4K_PEAK_GIB = 70.0    # the peak a chosen accumulation may be predicted at


def train_4k(cfg, params, m):
    """train_4k (B 256 x S 4,096, 1 M tokens a step) on one card:
    full-width dcache-agent-150m in bf16 through TrainLoop(...,
    accum_steps=N) with no checkpointer, on a batch of input_specs(cfg,
    TRAIN_4K)'s shapes with seeded tokens. First the peak memory of one
    micro-batch of accum 32 (8 x 4,096: its forward and backward, from the
    loop's own state: weights, moments, batch): the part above what it
    starts from grows with the micro-batch, which predicts the smallest N
    dividing 256 whose peak stays under 70 GiB. That N takes three steps
    (each step's peak memory beside the prediction). Every loss and
    grad_norm finite, the first loss within 0.5 of ln(vocab) (random
    weights), and no kernel launched: training takes the eager path."""
    from repro_torch.configs import TRAIN_4K, input_specs
    from repro_torch.training import AdamWConfig, TrainLoop
    from repro_torch.training.train_loop import loss_and_grads

    B, S = TRAIN_4K.global_batch, TRAIN_4K.seq_len
    specs = input_specs(cfg, TRAIN_4K)
    gen = torch.Generator(device="cuda").manual_seed(4)
    seq = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    batch = {"tokens": seq[:, :-1].contiguous(), "targets": seq[:, 1:].contiguous()}
    del seq
    assert ({k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
            == {k: (tuple(v.shape), v.dtype) for k, v in specs.items()})
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)

    def loop_for(n):
        return TrainLoop(cfg, opt, params, itertools.repeat(batch),
                         accum_steps=n)

    def peak_of(fn):
        """(fn's result, the memory held before it, its peak)."""
        free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, base, torch.cuda.max_memory_allocated()

    with counting_launches() as counts:
        loop = loop_for(TRAIN4K_FIRST_ACCUM)
        rows0 = B // TRAIN4K_FIRST_ACCUM
        (grads, m0), base, peak0 = peak_of(lambda: loss_and_grads(
            cfg, loop.params, {k: v[:rows0] for k, v in batch.items()}))
        loss0 = float(m0["loss"])
        del grads
        per_row = (peak0 - base) / rows0
        n = next(n for n in (1, 2, 4, 8, 16, 32, 64, 128, 256)
                 if base + per_row * (B // n) < TRAIN4K_PEAK_GIB * 2**30)
        predicted = base + per_row * (B // n)
        log(f"  train_4k: one micro-batch of accum {TRAIN4K_FIRST_ACCUM} ({rows0} "
            f"x {S}) peaks at {peak0 / 2**30:.3f} GiB over {base / 2**30:.3f} GiB "
            f"held before it (weights, moments, batch); predicted peak at accum "
            f"{n}: {predicted / 2**30:.2f} GiB (the smallest accum under "
            f"{TRAIN4K_PEAK_GIB:g} GiB)")
        del loop
        loop = loop_for(n)
        steps = [peak_of(lambda: loop.run(loop.step_idx + 1)) for _ in range(3)]
    losses = [loss0] + loop.history
    gnorms = [x["grad_norm"] for x, _, _ in steps]
    peak = max(p for _, _, p in steps)
    assert not any(counts.values()), "train_4k launched a hand-written kernel"
    assert all(map(math.isfinite, losses + gnorms)), "a loss or grad_norm is not finite"
    ln_v = math.log(cfg.vocab_size)
    assert abs(loss0 - ln_v) <= 0.5, f"first loss {loss0:.3f}, ln(vocab) {ln_v:.3f}"
    m["train_4k"] = dict(
        B=B, S=S, accum=n, micro_batch=B // n, first_accum=TRAIN4K_FIRST_ACCUM,
        first_micro_peak_bytes=peak0, base_bytes=base,
        predicted_peak_bytes=predicted, peak_bytes=peak,
        step_peak_bytes=[p for _, _, p in steps], losses=losses,
        grad_norms=gnorms)
    log(f"  train_4k at accum {n} ({B // n} x {S} micro-batches, bf16, remat "
        f"{cfg.remat}): 3 steps, peak {peak / 2**30:.3f} GiB (predicted "
        f"{predicted / 2**30:.2f}); losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (ln(vocab) {ln_v:.4f}); "
        f"grad_norms " + ", ".join(f"{x:.4f}" for x in gnorms)
        + "; no kernel launched")


def assigned_shapes():
    """Full-width dcache-agent-150m in bf16 at the assigned shapes:
    decode_32k, prefill_32k and train_4k on one card; long_500k is skipped
    by shape_applicable."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.models.model import init_model

    cfg = get_config("dcache-agent-150m")
    for name, shape in SHAPES.items():
        skip = shape_applicable(cfg, shape)
        if skip:
            log(f"  {name}: skipped by shape_applicable: {skip}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(cfg, gen, "cuda")
    m = {}
    counts = decode_32k(cfg, params, gen, m)
    free_card()
    c = prefill_32k(cfg, params, gen, m)
    free_card()
    train_4k(cfg, params, m)
    return {k: counts[k] + c[k] for k in counts}, m


# ---------------------------------------------------------------------------
# the serving bench's twin on the card
# ---------------------------------------------------------------------------

def bench_phase():
    """repro_torch.launch.serving_bench's run at its reference configuration
    (reduced dcache-agent-150m, head dim 16, the seeded weights of
    ``bench_serving``), its rows and its launch counts against the engine's
    own prefills and steps; bench_kernels' row."""
    from repro_torch.launch import serving_bench
    from repro_torch.models.model import init_model

    cfg = serving_bench.bench_config()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    with counting_launches() as counts:
        eng, reqs, seconds = serving_bench.run_bench(cfg, params, 6, 8, "cuda")
    rows = serving_bench.serving_rows(eng, seconds)
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    log("  " + " | ".join(rows) + f"; prefills={eng.prefills} "
        f"decode_steps={eng.steps} launches={counts} expected={expected}")
    assert all(r.done for r in reqs), "unfinished bench requests"
    assert counts == expected, "bench launch counts differ"
    assert rows[1] == "serving,requests,6"
    krow = serving_bench.bench_kernels()
    log("  " + krow[0])
    return counts, dict(rows=rows, kernel_row=krow[0], launches=counts)


# ---------------------------------------------------------------------------
# agent: the paper's system, its cache decisions made by the served model
# ---------------------------------------------------------------------------

AGENT_TASKS = 8
AGENT_NEW_TOKENS = 32
# the paper tables at the sizes tests/test_tables_determinism.py locks
TABLE_DIGESTS = {"table1": (40, "4a16fa741c2ec0e3"),
                 "table2": (30, "c843260e9b690452"),
                 "table3": (30, "4932ee22ebf094a7")}


class DecisionLog:
    """The controller's decision model with each call recorded: the
    prompt, its bytes, the prompt bytes the engine kept (``submit`` keeps
    the last ``max_len // 2`` tokens) and the completion. Without an engine
    (a SimLLM decision plane) it records the prompt, its bytes and the
    completion."""

    def __init__(self, llm, engine=None):
        self.llm, self.engine, self.calls = llm, engine, []

    def complete(self, prompt):
        eng = self.engine
        kept = eng.tok.encode(prompt)[-(eng.max_len // 2):] if eng else []
        out = self.llm.complete(prompt)
        self.calls.append(dict(
            prompt=prompt, prompt_bytes=len(prompt.encode()),
            kept_bytes=sum(i < 256 for i in kept), completion=out))
        return out


def run_agent(decision_llm, use_cache, n_tasks, seed=0):
    """``n_tasks`` of Table I's workload (reuse 0.8, task seed 1) through
    build_runtime's parts composed by hand: SimLLM (gpt-4-turbo, CoT,
    few-shot) drives the runner, ``decision_llm`` makes every read and
    update decision of the cached run (the run without the cache plans
    programmatically, as build_runtime's does). Returns the traces, the
    report, the controller and the cache."""
    from repro_torch.agent import AgentRunner, Profile, SimLLM, build_tasks
    from repro_torch.agent.geollm.datastore import GeoDataStore
    from repro_torch.agent.geollm.evaluator import evaluate
    from repro_torch.agent.geollm.geotools import make_geo_tools
    from repro_torch.agent.geollm.simclock import SimClock
    from repro_torch.core.cache import DataCache
    from repro_torch.core.controller import make_controller
    from repro_torch.core.policies import make_policy
    from repro_torch.core.tools import ToolRegistry, make_cache_tools

    clock = SimClock()
    store = GeoDataStore(clock)
    cache = DataCache(5, clock=clock.now)
    impl = "llm" if use_cache else "python"
    controller = make_controller(cache, make_policy("lru"), llm=decision_llm,
                                 read_impl=impl, update_impl=impl)
    registry = ToolRegistry(make_cache_tools(cache, store, clock)
                            + make_geo_tools(clock))
    runner = AgentRunner(registry, controller,
                         SimLLM(Profile("gpt-4-turbo", "cot", True), seed=seed),
                         clock, store, use_cache=use_cache)
    tasks = build_tasks(n_tasks, reuse_rate=0.8, seed=1, store=store)
    traces = [runner.run_task(t) for t in tasks]
    return traces, evaluate(tasks, traces, cache.stats), controller, cache


def same_traces(a, b):
    """TaskTraces equal field by field, answers by the workload's own
    structural equality (arrays and frames compared whole)."""
    from repro_torch.agent.geollm.workload import answers_equal

    assert len(a) == len(b), "trace counts differ"
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            ok = answers_equal(u, v) if f.name == "answers" else u == v
            assert ok, f"task {x.tid}: {f.name} differs ({u!r} vs {v!r})"


def agent_phase():
    """Full-width dcache-agent-150m in bf16 on the card as LLMController's
    decision model for AGENT_TASKS tasks, beside the same tasks without the
    cache; the launch counts of the whole phase against the engine's
    prefills and steps; then Tables I-III on the card's host against their
    digests."""
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.launch import tables
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("dcache-agent-150m")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    llm = DecisionLog(TorchLLM(eng, max_new_tokens=AGENT_NEW_TOKENS), eng)
    with counting_launches() as counts:
        off = run_agent(llm, False, AGENT_TASKS)
        assert not llm.calls, "the run without the cache asked the model"
        on = run_agent(llm, True, AGENT_TASKS)
        torch.cuda.synchronize()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    calls = llm.calls
    _, rep_off, _, _ = off
    traces, rep_on, ctrl, cache = on
    st = cache.stats
    m = dict(decisions=len(calls), prefills=eng.prefills, steps=eng.steps,
             prompt_bytes=[c["prompt_bytes"] for c in calls],
             kept_bytes=[c["kept_bytes"] for c in calls],
             parse_fallbacks=ctrl.parse_fallbacks,
             degraded=ctrl.degraded, graded=st.llm_total_decisions,
             graded_correct=st.llm_correct_decisions, hits=st.hits,
             misses=st.misses, evictions=st.evictions,
             avg_time_s_off=rep_off.avg_time_s, avg_time_s_on=rep_on.avg_time_s,
             sim_ratio=rep_off.avg_time_s / rep_on.avg_time_s,
             success_off=rep_off.success_rate, success_on=rep_on.success_rate,
             completions=[c["completion"] for c in calls][:4],
             launches=counts)
    log(f"  {len(calls)} decisions made by the model over {AGENT_TASKS} tasks "
        f"(prefills={eng.prefills} decode_steps={eng.steps}); prompt bytes "
        f"{m['prompt_bytes']}; kept by the engine {m['kept_bytes']}")
    log(f"  parse_fallbacks={ctrl.parse_fallbacks} "
        f"degraded={ctrl.degraded} graded={st.llm_total_decisions} "
        f"(correct {st.llm_correct_decisions}); cache hits={st.hits} "
        f"misses={st.misses} evictions={st.evictions}; first completions "
        f"{m['completions']!r}")
    log(f"  sim-clock avg_time_s without the cache {rep_off.avg_time_s:.4f}, "
        f"with it {rep_on.avg_time_s:.4f}, ratio {m['sim_ratio']:.4f}; "
        f"launches={counts} expected={expected}")
    assert calls and len(calls) == eng.prefills, "a decision did not reach the engine"
    assert ctrl.degraded == 0 and len(traces) == AGENT_TASKS
    assert all(math.isfinite(r.avg_time_s) and r.avg_time_s > 0
               for r in (rep_off, rep_on))
    assert counts == expected, "agent phase launch counts differ"
    for name, (n, digest) in TABLE_DIGESTS.items():
        rows = getattr(tables, name)(n=n)
        got = hashlib.sha256(repr(rows).encode()).hexdigest()[:16]
        log(f"  {name}(n={n}) digest {got} (locked {digest}); {rows[-1]}")
        assert got == digest, f"{name} digest differs on the card's host"
    return counts, m


def agent_cpu_vs_card():
    """The reduced dcache-agent-150m (head dim 16, vocab 512) in fp32 as
    the decision model for 2 tasks, on the CPU and on the card from the
    same weights: the same completions and the same TaskTraces; the card
    run's launch counts against its engine's prefills and steps."""
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                              vocab_size=512, dtype="float32")
    gpu_params = init_model(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    out = {}
    for device, params in (("cpu", tree_to(gpu_params, "cpu")), ("cuda", gpu_params)):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=128, device=device)
        llm = DecisionLog(TorchLLM(eng, max_new_tokens=8), eng)
        with counting_launches() as counts:
            traces = run_agent(llm, True, 2)[0]
        out[device] = (llm.calls, traces, counts,
                       expected_launches(cfg, eng.prefills, eng.steps))
    (c_calls, c_traces, _, _), (g_calls, g_traces, counts, expected) = out["cpu"], out["cuda"]
    assert counts == expected, "agent cpu vs card launch counts differ"
    assert [c["completion"] for c in g_calls] == [c["completion"] for c in c_calls], \
        "the card's completions differ from the CPU's"
    same_traces(c_traces, g_traces)
    log(f"  agent cpu vs card fp32 (reduced, 2 tasks): {len(g_calls)} decisions, "
        f"the same completions and TaskTraces; card launches={counts}")
    return dict(decisions=len(g_calls), launches=counts)


# ---------------------------------------------------------------------------
# concurrent: the fleet's cross-session cache decisions made by the model
# ---------------------------------------------------------------------------

CONC_SESSIONS, CONC_TASKS = 8, 5
# the headline cell of table_replication and table_llmfault, cut to 8
# sessions: 34 admission and 8 replication decisions under SimLLM
CONC_ENGINE = dict(n_pods=4, capacity_per_pod=5, seed=0, admission="tinylfu",
                   admission_impl="llm", replication=True, replication_impl="llm",
                   scenario="zipf",
                   scenario_kw={"zipf_a": 1.1, "zipf_global": True})
CONC_METRICS = ("p50_task_latency_s", "p95_task_latency_s", "local_hit_rate",
                "replication_agreement", "total_stall_s", "llm_parse_fallbacks",
                "admission_agreement", "n_tasks")
# the concurrent-engine tables at the sizes and digests the reference's
# tests lock (test_locality.py, test_coherence.py)
ENGINE_DIGESTS = (("table_concurrency", {"tasks_per_session": 25}, "8ec8ff89cfb17741"),
                  ("table_prefetch", {"tasks_per_session": 25}, "13335d76f3b853b8"),
                  ("table_admission", {"tasks_per_session": 25}, "0ab4ceee8be81cc2"),
                  ("table_replication", {"tasks_per_session": 25}, "4b8558d2647170c5"),
                  ("belady_bound", {"n": 200}, "0f372094aa0edaf3"),
                  ("table_resilience", {"tasks_per_session": 12, "mutations": True},
                   "9ed9f62ca396989d"))


def plane(prompt):
    """Which decision plane asked: the admission and replication prompts
    each name their controller."""
    if "cache admission controller" in prompt:
        return "admission"
    assert "cache REPLICATION controller" in prompt, prompt[:300]
    return "replication"


def run_concurrent(decision_llm, n_sessions, n_tasks, **kw):
    """One episode of the concurrent engine (CONC_ENGINE, ``kw`` over it).
    ``decision_llm`` replaces the SimLLM behind both the admission and the
    replication plane (public attributes, set after construction: the
    sessions' runners keep their own SimLLMs); None keeps the engine's own,
    each then wrapped in a DecisionLog to count its calls. Returns the
    engine, the result and the decision logs."""
    from repro_torch.agent.concurrency import ConcurrentEpisodeEngine

    eng = ConcurrentEpisodeEngine(n_sessions, **{**CONC_ENGINE, **kw})
    if decision_llm is None:
        logs = (DecisionLog(eng.admission_policy.llm),
                DecisionLog(eng.replicator.policy.llm))
    else:
        logs = (decision_llm,)
    eng.admission_policy.llm, eng.replicator.policy.llm = logs[0], logs[-1]
    return eng, eng.run(n_tasks, reuse_rate=0.8), logs


def episode_summary(eng, res, logs):
    calls = [c for lg in logs for c in lg.calls]
    by_plane = {"admission": [], "replication": []}
    for lg in logs:
        for c in lg.calls:
            by_plane[plane(c["prompt"])].append(c)
    m = {k: getattr(res.metrics, k) for k in CONC_METRICS}
    m.update(decisions={k: len(v) for k, v in by_plane.items()},
             parse_fallbacks={"admission": eng.admission_policy.parse_fallbacks,
                              "replication": eng.replicator.policy.parse_fallbacks},
             degraded={"admission": eng.admission_policy.degraded,
                       "replication": eng.replicator.policy.degraded},
             incomplete=res.metrics.resilience_incomplete_sessions)
    return m, calls


def concurrent_phase():
    """Full-width dcache-agent-150m in bf16 on the card behind the
    admission and replication planes of an 8-session episode of the
    concurrent engine, beside the same episode with the engine's own SimLLM
    planes; the launch counts of both runs against the served engine's
    prefills and steps; then the digest-locked concurrent tables on the
    card's host."""
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.core.coherence import MutationPlan
    from repro_torch.launch import tables
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("dcache-agent-150m")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    llm = DecisionLog(TorchLLM(eng, max_new_tokens=AGENT_NEW_TOKENS), eng)
    with counting_launches() as counts:
        base = episode_summary(*run_concurrent(None, CONC_SESSIONS, CONC_TASKS))[0]
        ceng, cres, logs = run_concurrent(llm, CONC_SESSIONS, CONC_TASKS)
        torch.cuda.synchronize()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    served, calls = episode_summary(ceng, cres, logs)
    m = dict(served=served, simllm=base, prefills=eng.prefills, steps=eng.steps,
             prompt_bytes=[c["prompt_bytes"] for c in calls],
             kept_bytes=[c["kept_bytes"] for c in calls],
             completions=[c["completion"] for c in calls][:4], launches=counts)
    log(f"  SimLLM planes: decisions {base['decisions']}; "
        + " ".join(f"{k}={base[k]}" for k in CONC_METRICS)
        + f"; parse_fallbacks {base['parse_fallbacks']} degraded {base['degraded']}")
    log(f"  served planes: {len(calls)} decisions made by the model "
        f"{served['decisions']} over {CONC_SESSIONS} sessions x {CONC_TASKS} "
        f"tasks (prefills={eng.prefills} decode_steps={eng.steps}); prompt bytes "
        f"{min(m['prompt_bytes'])}-{max(m['prompt_bytes'])}, kept by the engine "
        f"{min(m['kept_bytes'])}-{max(m['kept_bytes'])}")
    log("  served planes: "
        + " ".join(f"{k}={served[k]}" for k in CONC_METRICS)
        + f"; parse_fallbacks {served['parse_fallbacks']} degraded "
        f"{served['degraded']}; first completions {m['completions']!r}")
    log(f"  launches={counts} expected={expected}")
    assert calls and len(calls) == eng.prefills, "a decision did not reach the engine"
    assert all(v > 0 for v in served["decisions"].values()), \
        f"a decision plane was never asked: {served['decisions']}"
    assert base["decisions"] == {"admission": 34, "replication": 8}, base["decisions"]
    for run in (base, served):
        assert run["n_tasks"] == CONC_SESSIONS * CONC_TASKS and run["incomplete"] == 0
        assert not any(run["degraded"].values())
        assert all(math.isfinite(run[k]) for k in CONC_METRICS)
    assert counts == expected, "concurrent phase launch counts differ"
    m["digests"] = {}
    for name, kw, digest in ENGINE_DIGESTS:
        kw = dict(kw)
        if kw.pop("mutations", False):
            kw["engine_kw"] = {"mutations": MutationPlan()}
        got = hashlib.sha256(repr(getattr(tables, name)(**kw)).encode()).hexdigest()[:16]
        log(f"  {name}({kw}) digest {got} (locked {digest})")
        assert got == digest, f"{name} digest differs on the card's host"
        m["digests"][name] = got
    return counts, m


def concurrent_cpu_vs_card():
    """The reduced dcache-agent-150m (head dim 16, vocab 512) in fp32
    behind the admission and replication planes of small episodes (2 pods
    of capacity 2, CONC_ENGINE's scenario; 2 x 2 and 3 x 2 tasks, the
    second reaching the replication plane under the model's fallbacks), on
    the CPU and on the card from the same weights: the same completions
    and the same EpisodeMetrics row; the card's launch counts against its
    engine's prefills and steps."""
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                              vocab_size=512, dtype="float32")
    gpu_params = init_model(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    out = {}
    for n_sessions, n_tasks in ((2, 2), (3, 2)):
        runs = {}
        for device, params in (("cpu", tree_to(gpu_params, "cpu")), ("cuda", gpu_params)):
            eng = ServingEngine(cfg, params, max_batch=4, max_len=128, device=device)
            llm = DecisionLog(TorchLLM(eng, max_new_tokens=8), eng)
            with counting_launches() as counts:
                _, res, _ = run_concurrent(llm, n_sessions, n_tasks, n_pods=2,
                                           capacity_per_pod=2)
            runs[device] = (llm.calls, res.metrics.row(), counts,
                            expected_launches(cfg, eng.prefills, eng.steps))
        (c_calls, c_row, _, _), (g_calls, g_row, counts, expected) = runs["cpu"], runs["cuda"]
        assert counts == expected, "concurrent cpu vs card launch counts differ"
        assert [c["completion"] for c in g_calls] == [c["completion"] for c in c_calls], \
            "the card's completions differ from the CPU's"
        assert g_row == c_row, "the card's episode metrics differ from the CPU's"
        planes = {p: sum(plane(c["prompt"]) == p for c in g_calls)
                  for p in ("admission", "replication")}
        log(f"  concurrent cpu vs card fp32 (reduced, {n_sessions} sessions x "
            f"{n_tasks} tasks): decisions {planes}, the same completions and "
            f"metrics row; card launches={counts}")
        out[f"{n_sessions}x{n_tasks}"] = dict(decisions=planes, launches=counts)
    assert out["3x2"]["decisions"]["replication"] > 0, "no replication decision served"
    return out


# ---------------------------------------------------------------------------
# phase 5: training, then serving the trained weights
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 30


def batch_to(batch, device):
    """A TokenStream batch (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_full_width():
    """Full-width dcache-agent-150m in bf16 through the twin's own train()
    (TrainLoop over a Prefetcher of TokenStream(batch 8, seq 512, seed 0),
    AdamW lr 1e-3, 3 warmup steps, 30 steps): every loss and grad_norm
    finite, the mean of the last 5 losses at least 0.5 under the first 5's,
    no kernel launched. Before it the same 30 steps with remat="dots" from
    the same seeds: every loss within 1e-3 relative of block's. The trained
    params (bf16, no grad) then serve the twin's 8 prompts through its
    serve() with exact launch counts and one TorchLLM decision."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve_llm
    from repro_torch.models.model import init_model
    from repro_torch.training import AdamWConfig, Prefetcher, TokenStream

    def run(remat):
        """TRAIN_STEPS steps of the twin's train() under ``remat``, from the
        same weights and data seeds, launching no kernel."""
        cfg = dataclasses.replace(get_config("dcache-agent-150m"), remat=remat)
        params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        pf = Prefetcher(TokenStream(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=0))
        try:
            with counting_launches() as counts:
                loop, metrics = serve_llm.train(
                    cfg, params, pf, TRAIN_STEPS,
                    AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=TRAIN_STEPS))
        finally:
            pf.close()
        assert not any(counts.values()), "training launched a hand-written kernel"
        return cfg, loop, metrics

    # remat="dots" (the products' outputs kept) beside the default "block"
    dcfg, dloop, dmetrics = run("dots")
    del dloop
    free_card()
    cfg, loop, metrics = run("block")
    assert cfg.remat == "block" and dcfg.remat == "dots"
    losses = [m["loss"] for m in metrics]
    dots = dict(losses=[m["loss"] for m in dmetrics])
    dots["max_loss_rel"] = max(abs(a - b) / abs(b)
                               for a, b in zip(dots["losses"], losses))
    log(f"  remat dots vs block, {TRAIN_STEPS} steps at {TRAIN_B}x{TRAIN_S}: "
        f"largest loss difference {dots['max_loss_rel']:.2e} relative (<= 1e-3)")
    assert dots["max_loss_rel"] <= 1e-3, "dots and block losses differ"
    gnorms = [m["grad_norm"] for m in metrics]
    assert all(map(math.isfinite, losses + gnorms)), "a loss or grad_norm is not finite"
    first, last = statistics.fmean(losses[:5]), statistics.fmean(losses[-5:])
    assert last <= first - 0.5, f"loss fell from {first:.3f} to {last:.3f} only"
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad
               for t in tree_leaves(loop.params)), "trained params are not plain bf16"
    log(f"  trained {TRAIN_STEPS} steps at {TRAIN_B}x{TRAIN_S}: loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f} (mean of first 5 {first:.3f}, "
        f"last 5 {last:.3f}); grad_norm {gnorms[0]:.3f} -> {gnorms[-1]:.3f}; "
        f"kernel launches in training: 0")

    with counting_launches() as counts:
        eng, reqs = serve_llm.serve(cfg, loop.params, serve_llm.PROMPTS, device="cuda")
        text = serve_llm.decide(eng)
        torch.cuda.synchronize()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    assert all(r.done for r in reqs) and len(reqs) == 8, "unfinished requests"
    assert isinstance(text, str), "TorchLLM returned no text"
    log(f"  served the trained params: prefills={eng.prefills} "
        f"decode_steps={eng.steps} launches={counts} expected={expected}; "
        f"TorchLLM -> {text!r}")
    assert counts == expected, "launch counts differ from the main path's"
    return counts, dict(
        steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
        params=sum(t.numel() for t in tree_leaves(loop.params)),
        losses=losses, grad_norms=gnorms, first5=first, last5=last,
        serve_launches=counts, decision=text, dots=dots)


def smoke_launchers():
    """launch.serve's ``--smoke`` main (reduced dcache-agent-150m, and
    ``--arch rwkv6-7b``: WKV and rmsnorm at head dim 16) and
    launch.serve_llm's on the card, each held to the launch counts its
    returned engine's prefills and steps imply (serve_llm's training
    launches none)."""
    from repro_torch.launch import serve, serve_llm

    counts, m = {}, {}
    for name, argv, fn in (("launch.serve", ["--smoke"], serve.main),
                           ("launch.serve rwkv6-7b", ["--smoke", "--arch", "rwkv6-7b"],
                            serve.main),
                           ("launch.serve_llm", ["--smoke"], serve_llm.main)):
        with counting_launches() as c:
            eng = fn(argv)
            torch.cuda.synchronize()
        expected = expected_launches(eng.cfg, eng.prefills, eng.steps)
        m[name] = dict(prefills=eng.prefills, steps=eng.steps, launches=c)
        log(f"  {name} --smoke on cuda: prefills={eng.prefills} "
            f"decode_steps={eng.steps} launches={c} expected={expected}")
        assert eng.steps > 0 and c == expected, f"{name}: launch counts differ"
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts, m


def train_cpu_vs_card(arch, B, S):
    """One make_train_step step of ``arch`` at full width cut to 2 layers,
    fp32, on the CPU and on the card: the loss within 1e-4 relative, the
    grad_norm within 1e-3; and the largest per-leaf gradient error relative
    to the leaf's max (from loss_and_grads), recorded."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.training import (AdamWConfig, TokenStream, init_opt_state,
                                      make_train_step)
    from repro_torch.training.train_loop import loss_and_grads

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    gpu_params = init_model(cfg, torch.Generator(device="cuda").manual_seed(1),
                            "cuda")
    cpu_params = tree_to(gpu_params, "cpu")
    batch = TokenStream(cfg, batch=B, seq=S, seed=2).next_batch()
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10))
    out = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        b = batch_to(batch, dev)
        _, _, m = step(p, init_opt_state(p), b)
        grads, _ = loss_and_grads(cfg, p, b)
        out[dev] = (m, tree_leaves(grads))
    (mc, gc_), (mg, gg) = out["cpu"], out["cuda"]
    loss_rel = abs(float(mc["loss"]) - float(mg["loss"])) / abs(float(mc["loss"]))
    gn_rel = abs(float(mc["grad_norm"]) - float(mg["grad_norm"])) / float(mc["grad_norm"])
    leaf_rel = max((a - b.cpu()).abs().max().item() / max(a.abs().max().item(), 1e-30)
                   for a, b in zip(gc_, gg))
    log(f"  {arch} train step cpu vs card fp32 (2 layers, full width, B={B} "
        f"S={S}): loss {float(mc['loss']):.6f} vs {float(mg['loss']):.6f} "
        f"(rel {loss_rel:.2e} <= 1e-4), grad_norm {float(mc['grad_norm']):.6f} "
        f"vs {float(mg['grad_norm']):.6f} (rel {gn_rel:.2e} <= 1e-3), largest "
        f"per-leaf gradient error / leaf max {leaf_rel:.2e}")
    assert loss_rel <= 1e-4, f"{arch}: loss differs by {loss_rel:.2e} relative"
    assert gn_rel <= 1e-3, f"{arch}: grad_norm differs by {gn_rel:.2e} relative"
    return dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, leaf_rel=leaf_rel)


# ---------------------------------------------------------------------------
# phase 6: checkpoints on disk, cold restarts, serving the restored weights
# ---------------------------------------------------------------------------

CKPT_STEPS = 4
TINY_STEPS = 60


def same_loop_state(a, b, where):
    """Two TrainLoops hold equal params, moments and step, bit for bit."""
    pairs = list(zip(tree_leaves(a.params), tree_leaves(b.params))) + list(
        zip(tree_leaves(a.opt_state), tree_leaves(b.opt_state)))
    assert len(pairs) == len(tree_leaves(a.params)) * 3 + 1
    for x, y in pairs:
        assert x.dtype == y.dtype and x.shape == y.shape, where
        assert torch.equal(x, y.to(x.device)), f"{where}: a leaf differs"
    assert a.step_idx == b.step_idx, where
    assert a.params["embed"].dtype == torch.bfloat16
    assert a.opt_state["mu"]["embed"].dtype == torch.float32


def checkpoint_phase():
    """Train full-width dcache-agent-150m through the launcher with one
    save at the end, restore it cold on the card and on the CPU (bit for
    bit), serve the restored weights with exact launch counts, then run the
    fault-tolerance example on the card."""
    import shutil

    from repro_torch.launch import serve_llm, train, train_tiny

    ckdir = os.path.join(ROOT, "build", "ckpt_phase6")
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = ["--arch", "dcache-agent-150m", "--preset", "full",
            "--steps", str(CKPT_STEPS), "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_S), "--lr", "1e-3", "--ckpt-dir", ckdir,
            "--ckpt-every", "0"]
    with counting_launches() as counts:
        loop = train.main(argv)
    assert not any(counts.values()), "training launched a hand-written kernel"
    assert all(map(math.isfinite, loop.history)), "a loss is not finite"
    ck = loop.ckpt
    assert ck.available_steps() == [CKPT_STEPS], "not exactly one checkpoint"
    m = dict(codec=ck.codec, steps=CKPT_STEPS, losses=loop.history)
    log(f"  trained {CKPT_STEPS} steps at {TRAIN_B}x{TRAIN_S} through "
        f"launch.train (loss {loop.history[0]:.3f} -> {loop.history[-1]:.3f}); "
        f"one save at step {CKPT_STEPS}, codec {ck.codec}")

    restored = {}
    for dev in ("cuda", "cpu"):
        loop2, data = train.build(train.parse_args(
            argv + ["--resume", "--device", dev]))
        data.close()
        same_loop_state(loop2, loop, f"cold restart on {dev}")
        assert loop2.params["embed"].device.type == dev
        restored[dev] = loop2
        log(f"  cold restart with --resume on {dev}: params (bf16), mu/nu "
            f"(fp32) and step {loop2.step_idx} equal to the saved ones bit for bit")
    del restored["cpu"]
    shutil.rmtree(ckdir, ignore_errors=True)

    cfg = loop.cfg
    with counting_launches() as counts:
        eng, reqs = serve_llm.serve(cfg, restored["cuda"].params, serve_llm.PROMPTS,
                                    device="cuda")
        torch.cuda.synchronize()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    assert all(r.done for r in reqs) and len(reqs) == 8, "unfinished requests"
    log(f"  served the restored params: prefills={eng.prefills} "
        f"decode_steps={eng.steps} launches={counts} expected={expected}")
    assert counts == expected, "launch counts differ from the main path's"
    _, reqs0 = serve_llm.serve(cfg, loop.params, serve_llm.PROMPTS, device="cuda")
    assert [r.out_ids for r in reqs] == [r.out_ids for r in reqs0], \
        "the restored weights generate other tokens than the saved ones"
    m["serve_launches"] = counts
    del loop, restored, eng
    free_card()

    tiny = train_tiny.main(["--steps", str(TINY_STEPS)])
    fails = tiny["failures"]
    assert [f["restored"] for f in fails] == [True, True], \
        f"failures not recovered from disk: {fails}"
    assert tiny["restarted"].step_idx == TINY_STEPS, "cold restart is short"
    assert tiny["loop"].params["embed"].is_cuda
    m["train_tiny"] = dict(steps=TINY_STEPS, fail_at=tiny["fail_at"],
                           failures=fails, kept=tiny["kept"],
                           losses=tiny["loop"].history)
    log(f"  train_tiny on the card ({tiny['loop'].cfg.name}, {TINY_STEPS} "
        f"steps): failures at {tiny['fail_at']} recovered from disk, kept "
        f"{tiny['kept']}, cold restart at step {TINY_STEPS}")
    return counts, m


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_s = {}
    counts = dict.fromkeys(LAUNCHERS.values(), 0)

    def phase(name, fn, *args, **kw):
        """fn's result, its seconds into phase_s; the card freed after it."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        free_card()
        return out

    def counted(name, fn, *args, **kw):
        """A phase that returns (launches, record): its launches added to
        the run's, its record returned."""
        c, record = phase(name, fn, *args, **kw)
        for k, v in c.items():
            counts[k] += v
        return record

    log("phase 1: build")
    phase("1", _build.load_library)
    ptxas = str(_build.build_log.get("ptxas", ""))
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(ptxas)
    for line in ptxas.splitlines():   # per kernel: name, spills, registers
        if line.startswith("==") or "entry function" in line or "Used" in line \
                or "spill" in line:
            log("  " + line.strip())
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas)
    assert all(a == b == "0" for a, b in spills), "a kernel instance spills"
    log(f"  {len(spills)} kernel instances built, none spills")
    small = instances(ptxas, SMALL_DIM_NAMES)
    for name, regs, spill in small:
        log(f"  head dim {name}: {regs} registers, {spill}")
    assert len(small) == 12, f"expected 12 head-dim 16/32 instances, got {len(small)}"
    wkv = instances(ptxas, WKV_NAMES)
    for name, regs, spill in wkv:
        log(f"  WKV head dim {name}: {regs} registers, {spill}")
    assert len(wkv) == 12, f"expected 12 WKV instances, got {len(wkv)}"
    rope_regs = instances(ptxas, ROPE_NAMES)
    for name, regs, spill in rope_regs:
        log(f"  rope vec {name}: {regs} registers, {spill}")
    assert len(rope_regs) == 4, f"expected 4 rope instances, got {len(rope_regs)}"

    log("phase 2: kernels against their plain versions on the card")
    errs = {}
    phase("2", check_kernels, errs)
    timing = phase("2 timing", time_kernels)

    serve = {}
    for arch, kvq, layers in SERVED_PATHS:
        name = arch + ("+kv_quant" if kvq else "")
        log(f"phase 3: full-width serving, {name}")
        if get_config(arch).is_encdec:
            serve[name] = counted("3 " + name, serve_encdec, arch)
        else:
            serve[name] = counted("3 " + name, serve_full_width, arch,
                                  kv_quant=kvq, n_layers=layers)

    log("paged phase: the paged KV cache at full width")
    paged = counted("paged", paged_phase)
    errs["decode_attention"] = max(errs["decode_attention"], paged["max_abs_err"])

    log("assigned shapes: decode_32k, prefill_32k and train_4k, full-width "
        "dcache-agent-150m in bf16")
    shapes = counted("assigned shapes", assigned_shapes)
    for k, v in shapes.pop("errs").items():
        errs[k] = max(errs[k], v)

    log("bench: the serving bench's twin on the card")
    bench = counted("bench", bench_phase)

    log("agent: the paper's cache decisions made by full-width "
        "dcache-agent-150m on the card")
    agent = counted("agent", agent_phase)

    log("concurrent: the fleet's admission and replication decisions made by "
        "full-width dcache-agent-150m on the card")
    conc = counted("concurrent", concurrent_phase)

    # phase 4 covers each kernel instance's head dim and group: d 64 (dense,
    # kv_quant), the WKV path, d 128 at G 4 with qk_norm, d 96 at G 1, d 128
    # at G 1 with non-zero QKV biases, the MoE block at d 128 G 6, and the
    # Mamba heads beside attention at d 64 G 3
    for arch, kvq in (("dcache-agent-150m", False), ("dcache-agent-150m", True),
                      ("rwkv6-7b", False), ("qwen3-4b", False),
                      ("phi3-mini-3.8b", False), ("qwen1.5-32b", False),
                      ("mixtral-8x22b", False), ("hymba-1.5b", False),
                      ("seamless-m4t-large-v2", False), ("llava-next-34b", False)):
        name = arch + ("+kv_quant" if kvq else "")
        log(f"phase 4: CPU vs card, fp32, {name}")
        worst, ties, flips = phase("4 " + name, cpu_vs_card, arch, kv_quant=kvq)
        serve[name].update(cpu_vs_card_max_logit_diff=worst,
                           cpu_vs_card_near_ties=ties,
                           cpu_vs_card_int8_code_flips=flips)
    # the reduced configs (head dim 16) of every family: the dense ones (the
    # four variants too), rwkv6 (WKV at head dim 16), MoE (llama4 too: its
    # reduced super-layer fits where full width does not), hybrid, encdec
    # and vlm; then the launchers' --smoke mains on the card
    reduced = {}
    for arch in REDUCED_ARCHS:
        log(f"phase 4: CPU vs card, fp32, {arch} reduced")
        worst, ties, _ = phase(f"4 {arch} reduced", cpu_vs_card, arch, reduced=True)
        reduced[arch] = dict(max_logit_diff=worst, near_ties=ties)
    log("phase 4: CPU vs card, fp32, the reduced dcache as the cache "
        "controller's decision model")
    agent["cpu_vs_card"] = phase("4 agent", agent_cpu_vs_card)
    log("phase 4: CPU vs card, fp32, the reduced dcache as the concurrent "
        "engine's admission and replication decision model")
    conc["cpu_vs_card"] = phase("4 concurrent", concurrent_cpu_vs_card)
    log("phase 4: the launchers' --smoke mains on the card")
    smoke = counted("4 smoke launchers", smoke_launchers)

    log("phase 5: training on the card, then serving the trained weights")
    training = counted("5", train_full_width)
    for arch, B, S in (("dcache-agent-150m", 2, 64), ("rwkv6-7b", 1, 32)):
        training[f"cpu_vs_card_{arch}"] = phase(f"5 {arch} cpu vs card",
                                                train_cpu_vs_card, arch, B, S)

    log("phase 6: checkpoints, cold restarts, serving the restored weights")
    ckpt = counted("6", checkpoint_phase)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    src = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:27"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:80"),
           # no Pallas counterpart: the XLA dequantize + attention chain of
           # decode_attend (src/repro/models/attention.py:217-250)
           "decode_attention_int8": (
               "src/repro_torch/kernels/csrc/decode_attention.cu",
               "src/repro/models/attention.py:197"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:108"),
           "wkv": ("src/repro_torch/kernels/csrc/rwkv_wkv.cu",
                   "src/repro/kernels/rwkv_wkv.py:56"),
           # no Pallas counterpart: the jnp rope (src/repro/models/common.py)
           # and decode_attend's ring write
           "rope": ("src/repro_torch/kernels/csrc/rope.cu",
                    "src/repro/models/common.py:rope")}
    # launches: summed over every phase that counts them (phase 3's served
    # paths, the paged phase, the assigned shapes, the bench, the agent and
    # concurrent phases, the --smoke mains and the serving of the trained
    # and of the restored weights), each held to the counts its own
    # prefills and steps imply (expected_launches)
    # dims_held: the head dims (row widths for rmsnorm) each kernel was held
    # at in phase 2; the times are at dcache-agent-150m's (or rwkv6-7b's)
    # shapes, the other served shapes' are in chip_smoke.json's "timing"
    kernels = [{"name": n, "route": "cuda", "source": src[n][0],
                "replaces": src[n][1], "launches": counts[n],
                "max_abs_err": errs[n], "ms": timing[n]["ms"],
                "plain_ms": timing[n]["plain_ms"],
                "bound_ms": timing[n]["bound_ms"],
                "bound_by": timing[n]["bound_by"],
                "library_ms": timing[n]["library_ms"],
                "dims_held": sorted(HELD[n])} for n in src]
    result = {"card": card, "serving": serve, "paged": paged,
              "assigned_shapes": shapes, "bench": bench, "agent": agent,
              "concurrent": conc,
              "reduced_cpu_vs_card": reduced, "smoke_launchers": smoke,
              "training": training, "checkpoint": ckpt, "timing": timing,
              "max_abs_err": errs, "max_abs_err_by_dim": HELD, "kernels": kernels,
              "phase_s": phase_s,
              "command_s": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(f"total {result['command_s']:.1f} s; phase seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
