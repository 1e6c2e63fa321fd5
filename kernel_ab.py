#!/usr/bin/env python3
"""Time the kernels of other kernel source trees against this checkout's,
in turns, on one NVIDIA card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 kernel_ab.py build/parent/src/repro_torch/kernels/csrc [DIR ...]

Each DIR holds ``*.cu`` sources with the C entry points of
``src/repro_torch/kernels/_build.py`` (same signatures). ``_build`` builds
this checkout's kernels and each DIR into a library of its own, and each
tree's ptxas registers and spills are printed. For each DIR the order is
DIR, this tree, this tree, DIR. Each entry is the kernel's device time per
launch from ``torch.profiler`` (mean over 50 calls), in bf16, at the served
shapes and a few others, for all four kernels; decode attention also at the
benchmark cells' decode steps (``chip_smoke.SERVED_DECODE``), and the int8
decode kernel at mixtral-decide's. Each output is checked
against this tree's output: attention within 2e-2 absolute; rmsnorm and
the WKV y within 2e-2 absolute and relative, as chip_smoke.py holds them
(two correct sum orders can round a value to bf16 one ulp apart: 0.25 at
|y| ~ 60), and the WKV state (fp32) within 1e-4. Without a CUDA device it
exits non-zero.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

WKV_TOLS = ((2e-2, 2e-2), (1e-4, 1e-4))  # y (bf16), state (fp32)


def load_tree(name, csrc=None):
    """Build (or reuse) the library of csrc and print its ptxas usage."""
    from repro_torch.kernels import _build

    _build.build_log.clear()
    lib = _build.load_library() if csrc is None else _build.load_library(csrc)
    for line in str(_build.build_log.get("ptxas", "")).splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"{name}: {line.strip()}")
    return lib


def device_us(fn, needle, iters=50):
    """Device time per launch of the kernel whose name holds needle (fn
    launches one such kernel per call): the mean over the launches the
    profiler recorded, which may miss some."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [a for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA and needle in a.key]
    n = sum(a.count for a in hits)
    if n == 0:
        raise RuntimeError(f"the profiler recorded no {needle} launch")
    return sum(a.self_device_time_total for a in hits) / n


def cases():
    """(name, call, kernel-name needle, (atol, rtol) of each output) at the
    served shapes and beyond."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    B, Hq, Hkv, d = 4, 12, 4, 64
    out = []
    for C, what in ((512, "full ring"), (512, "pos 0"), (64, "full ring"),
                    (4096, "full ring")):
        kc = torch.randn((B, C, Hkv * d), generator=gen, device="cuda").to(dt)
        vc = torch.randn((B, C, Hkv * d), generator=gen, device="cuda").to(dt)
        k = kc.view(B, C, Hkv, d).transpose(1, 2)
        v = vc.view(B, C, Hkv, d).transpose(1, 2)
        q = torch.randn((B, Hq, d), generator=gen, device="cuda").to(dt)
        pos = [C + 3, C + 40, 2 * C + 5, 3 * C] if what == "full ring" else [0] * B
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out.append((f"decode_attention C={C} {what}",
                    lambda q=q, k=k, v=v, p=p: ops.decode_attention(q, k, v, p),
                    "decode_kernel", ((2e-2, 0.0),)))
    # the benchmark cells' decode steps (chip_smoke.SERVED_DECODE), each row
    # at its own position, a ragged mixtral-decide batch (pos 0, ~2,000,
    # C - 1 and a wrapped row among them) and the int8 kernel there
    from chip_smoke import SERVED_DECODE, served_pos, served_ring
    for name, Bs, Hqs, Hkvs, ds, C, lo, hi in SERVED_DECODE:
        variants = [("", False, False)]
        if name == "mixtral decide":
            variants += [(" ragged", True, False), (" int8", False, True)]
        for tag, ragged, int8 in variants:
            k, v, ks, vs = served_ring(gen, Bs, C, Hkvs, ds, dt, int8)
            q = torch.randn((Bs, Hqs, ds), generator=gen, device="cuda").to(dt)
            p = served_pos(gen, Bs, C, lo, hi, ragged)
            if int8:
                fn = lambda q=q, k=k, v=v, ks=ks, vs=vs, p=p: \
                    ops.decode_attention_int8(q, k, v, ks, vs, p)  # noqa: E731
            else:
                fn = lambda q=q, k=k, v=v, p=p: ops.decode_attention(q, k, v, p)  # noqa: E731
            out.append((f"decode_attention served {name}{tag} C={C} pos "
                        f"{int(p.min())}-{int(p.max())}", fn,
                        "decode_int8_kernel" if int8 else "decode_kernel",
                        ((2e-2, 0.0),)))
    for S in (64, 512):
        q = torch.randn((1, S, Hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, S, Hkv, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, S, Hkv, d), generator=gen, device="cuda").to(dt)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out.append((f"flash_attention S={S} causal",
                    lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
                    "flash_kernel", ((2e-2, 0.0),)))
    # rmsnorm at the served shapes: dense (4,1,768), rwkv (4,1,4096) and the
    # per-head ln_x norm (4,1,64,64); also with the L2 cache cold: a 64 MB
    # read (more than the 50 MB L2) before each call, as a served step
    # streams its weights through L2 between two calls
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    for shp in ((4, 1, 768), (4, 1, 4096), (4, 1, 64, 64)):
        x = torch.randn(shp, generator=gen, device="cuda").to(dt)
        g = torch.randn(shp[-1], generator=gen, device="cuda").to(dt)
        out.append((f"rmsnorm x {shp}", lambda x=x, g=g: ops.rmsnorm(x, g),
                    "rmsnorm_kernel", ((2e-2, 2e-2),)))
        out.append((f"rmsnorm x {shp}, L2 cold",
                    lambda x=x, g=g: (flush.sum(), ops.rmsnorm(x, g))[1],
                    "rmsnorm_kernel", ((2e-2, 2e-2),)))
    # WKV at the rwkv6-7b decode step (B 4, S 1, a random state; written to
    # a buffer of its own so that every call sees the same state) and at
    # prefills of 48 and 512 steps from a zero state
    H = 64
    for B, S in ((4, 1), (1, 48), (1, 512)):
        r, k, v = (torch.randn((B, S, H, d), generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        w = 0.8 + 0.199 * torch.rand((B, S, H, d), generator=gen, device="cuda")
        u = torch.randn((H, d), generator=gen, device="cuda").to(dt)
        s0 = torch.randn((B, H, d, d), generator=gen, device="cuda") \
            if S == 1 else None
        s_out = torch.empty((B, H, d, d), device="cuda")
        out.append((f"wkv B={B} S={S}" + (" decode" if S == 1 else ""),
                    lambda r=r, k=k, v=v, w=w, u=u, s0=s0, s_out=s_out:
                    ops.wkv(r, k, v, w, u, s0=s0, state_out=s_out),
                    "wkv_kernel", WKV_TOLS))
        if S == 1:
            out.append(("wkv B=4 S=1 decode, L2 cold",
                        lambda r=r, k=k, v=v, w=w, u=u, s0=s0, s_out=s_out:
                        (flush.sum(),
                         ops.wkv(r, k, v, w, u, s0=s0, state_out=s_out))[1],
                        "wkv_kernel", WKV_TOLS))
    return out


def agree(out, ref, tols):
    """Max abs difference of each output (a tensor or a tuple of them), and
    whether each is within its (atol, rtol)."""
    out, ref = (o if isinstance(o, tuple) else (o,) for o in (out, ref))
    errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(out, ref)]
    ok = all(torch.allclose(a.float(), b.float(), atol=at, rtol=rt)
             for a, b, (at, rt) in zip(out, ref, tols))
    return errs, ok


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = {"this tree": load_tree("this tree"),
            **{t: load_tree(t, t) for t in trees}}
    calls = cases()
    gold = [tuple(t.clone() for t in o) if isinstance(o, tuple) else o
            for o in (fn() for _, fn, _, _ in calls)]
    times = {}
    load = _build.load_library
    try:
        for tree in trees:
            for name in (tree, "this tree", "this tree", tree):
                _build.load_library = lambda lib=libs[name]: lib
                for (case, fn, needle, tols), ref in zip(calls, gold):
                    errs, ok = agree(fn(), ref, tols)
                    if not ok:
                        raise AssertionError(f"{name} {case}: differs by {errs}")
                    try:
                        t = device_us(fn, needle)
                    except RuntimeError as e:
                        raise RuntimeError(f"{name} {case}: {e}") from None
                    times.setdefault((case, name), []).append(t)
    finally:
        _build.load_library = load
    print(f"card: {card}")
    for case, _, _, _ in calls:
        print(f"{case}: " + " | ".join(
            f"{name} " + ", ".join(f"{t:.2f}" for t in times[(case, name)]) + " us"
            for name in ["this tree", *trees]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
