#!/usr/bin/env python3
"""Time the attention kernels of other kernel source trees against this
checkout's, in turns, on one NVIDIA card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 kernel_ab.py build/parent/src/repro_torch/kernels/csrc [DIR ...]

Each DIR holds ``*.cu`` sources with the C entry points of
``src/repro_torch/kernels/_build.py`` (same signatures). ``_build`` builds
this checkout's kernels and each DIR into a library of its own, and each
tree's ptxas registers and spills are printed. For each DIR the order is
DIR, this tree, this tree, DIR. Each entry is the kernel's device time per
call from ``torch.profiler`` (mean of 50 calls), in bf16, at the served
shapes and a few others. Each output is checked against this tree's output
(within 2e-2). Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


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
    """Device time per call of the kernels whose name holds needle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(a.self_device_time_total / iters for a in prof.key_averages()
               if a.device_type == DeviceType.CUDA and needle in a.key)


def cases():
    """(name, call, kernel-name needle) at the served shapes and beyond."""
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
                    "decode_kernel"))
    for S in (64, 512):
        q = torch.randn((1, S, Hq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((1, S, Hkv, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((1, S, Hkv, d), generator=gen, device="cuda").to(dt)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        out.append((f"flash_attention S={S} causal",
                    lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
                    "flash_kernel"))
    return out


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
    gold = [fn() for _, fn, _ in calls]
    times = {}
    load = _build.load_library
    try:
        for tree in trees:
            for name in (tree, "this tree", "this tree", tree):
                _build.load_library = lambda lib=libs[name]: lib
                for (case, fn, needle), ref in zip(calls, gold):
                    err = (fn().float() - ref.float()).abs().max().item()
                    if err > 2e-2:
                        raise AssertionError(f"{name} {case}: differs by {err:.3e}")
                    times.setdefault((case, name), []).append(
                        device_us(fn, needle))
    finally:
        _build.load_library = load
    print(f"card: {card}")
    for case, _, _ in calls:
        print(f"{case}: " + " | ".join(
            f"{name} " + ", ".join(f"{t:.2f}" for t in times[(case, name)]) + " us"
            for name in ["this tree", *trees]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
