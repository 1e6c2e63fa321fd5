#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from src/repro_torch/kernels/csrc/ and print the
     build time and ptxas report;
  2. hold each kernel against its plain PyTorch version on the card, in bf16
     (atol = rtol = 2e-2) and fp32 (1e-4, sums in another order), at the main
     path's shapes and ragged ones; time kernel, plain version and the
     library call (CUDA events, median of 50) at the main path's shapes;
  3. serve dcache-agent-150m at full width in bf16 (random weights from a
     seeded torch.Generator): ServingEngine(max_batch=4, max_len=512), 8
     prompts x 32 new tokens, then one TorchLLM.complete; the launch counters
     must equal the exact numbers the path implies; profile a decode step,
     a prefill and the unembed (held against an fp32 product within 1e-3);
  4. the same full-width weights cut to 2 layers, in fp32, on the CPU (plain
     versions) and on the card (kernels): prefill + 8 greedy decode steps on
     3 prompts; logits within 1e-3 and the same greedy tokens (or a top-2
     gap within the tolerance where a token differs);
  5. print the card's name and power limit and the kernels' JSON line, then
     the result line.

It imports nothing of JAX or of the JAX package ``repro``. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.launch.serve import PROMPTS  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
OUT_DIR = os.path.join(ROOT, "chiprun_out")


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


def device_profile(fn, iters, table_file=None):
    """torch.profiler over ``iters`` calls of fn: device time per call by
    kernel name (us) and the device-busy share of the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_call = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            per_call[a.key] = (per_call.get(a.key, 0.0)
                               + a.self_device_time_total / iters)
    if table_file:
        with open(os.path.join(OUT_DIR, table_file), "w") as f:
            f.write(prof.key_averages().table(row_limit=60))
    return per_call, sum(per_call.values()) * iters / wall_us, wall_us / iters


def kernel_device_us(per_call, needle):
    return sum(t for k, t in per_call.items() if needle in k)


def bound_ms(nbytes, flops, dtype):
    t_b = nbytes / PEAK_BYTES_S
    t_f = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def compare(name, case, out, gold, dtype, errs):
    err = (out.float() - gold.float()).abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(out.float(), gold.float(), atol=tol, rtol=tol)
    log(f"  {name} {case} {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"tol(atol=rtol)={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case}: kernel disagrees with plain version")
    errs[name] = max(errs.get(name, 0.0), err)


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(errs):
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, Hq, Hkv, d = 4, 12, 4, 64
    for dtype in (torch.bfloat16, torch.float32):
        for rows in (1, 4, 257):
            for dm in (64, 768):
                x = randn(gen, rows, dm, dtype=dtype)
                g = randn(gen, dm, dtype=dtype)
                compare("rmsnorm", f"rows={rows} d={dm}", ops.rmsnorm(x, g),
                        rmsnorm_plain(x, g), dtype, errs)
        for S in (8, 9, 37, 64, 256):
            # the model's layouts: q (1,S,Hq,d), k/v (1,S,Hkv,d), seen as (B,H,S,d)
            q = randn(gen, 1, S, Hq, d, dtype=dtype).transpose(1, 2)
            k = randn(gen, 1, S, Hkv, d, dtype=dtype).transpose(1, 2)
            v = randn(gen, 1, S, Hkv, d, dtype=dtype).transpose(1, 2)
            for mask, kw in (("causal", {}), ("window16", {"window": 16}),
                             ("chunk32", {"chunk": 32}),
                             ("full", {"causal": False})):
                compare("flash_attention", f"S={S} {mask}",
                        ops.flash_attention(q, k, v, **kw),
                        flash_attention_plain(q, k, v, **kw), dtype, errs)
        for C in (64, 512):
            kc = randn(gen, B, C, Hkv * d, dtype=dtype)   # the cache slice
            vc = randn(gen, B, C, Hkv * d, dtype=dtype)
            k = kc.view(B, C, Hkv, d).transpose(1, 2)
            v = vc.view(B, C, Hkv, d).transpose(1, 2)
            q = randn(gen, B, Hq, d, dtype=dtype)
            for pcase, pos in (("pos<C", [0, 5, 17, C // 2]),
                               ("pos=C-1", [C - 1] * B),
                               ("pos>2C", [2 * C + 1, 2 * C + 7, 3 * C + 3, 5 * C])):
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                for mask, kw in (("none", {}), ("window48", {"window": 48}),
                                 ("chunk32", {"chunk": 32})):
                    compare("decode_attention", f"C={C} {pcase} {mask}",
                            ops.decode_attention(q, k, v, p, **kw),
                            decode_attention_plain(q, k, v, p, **kw), dtype, errs)


def time_kernels():
    """Kernel / plain / library times at the main path's shapes (bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain

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
        device_us=kernel_device_us(device_profile(
            lambda: ops.rmsnorm(x, g), 20)[0], "rmsnorm_kernel"),
        bound_ms=b, bound_by=by)

    # decode attention at a decode step: B=4, C=512, a full ring (pos > C)
    B, Hq, Hkv, C, d = 4, 12, 4, 512, 64
    kc = randn(gen, B, C, Hkv * d, dtype=dt)
    vc = randn(gen, B, C, Hkv * d, dtype=dt)
    k = kc.view(B, C, Hkv, d).transpose(1, 2)
    v = vc.view(B, C, Hkv, d).transpose(1, 2)
    q = randn(gen, B, Hq, d, dtype=dt)
    pos = torch.tensor([C + 3, C + 40, 2 * C + 5, 3 * C], dtype=torch.int32,
                       device="cuda")
    valid = sum(min(int(p) + 1, C) for p in pos)
    nb = (2 * q.numel() + 2 * valid * Hkv * d) * es + pos.numel() * 4
    b, by = bound_ms(nb, 4 * valid * Hq * d, dt)
    kk, vv, qq = k.contiguous(), v.contiguous(), q[:, :, None]
    mask = torch.ones((B, 1, 1, C), dtype=torch.bool, device="cuda")
    rows["decode_attention"] = dict(
        shape=f"q ({B},{Hq},{d}), cache ({B},{C},{Hkv * d}) bf16, full ring",
        ms=time_ms(lambda: ops.decode_attention(q, k, v, pos)),
        plain_ms=time_ms(lambda: decode_attention_plain(q, k, v, pos)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask, enable_gqa=True)),
        device_us=kernel_device_us(device_profile(
            lambda: ops.decode_attention(q, k, v, pos), 20)[0], "decode_kernel"),
        bound_ms=b, bound_by=by)

    # prefill attention at the commonest prompt bucket: B=1, S=64, causal
    S = 64
    q = randn(gen, 1, S, Hq, d, dtype=dt).transpose(1, 2)
    k = randn(gen, 1, S, Hkv, d, dtype=dt).transpose(1, 2)
    v = randn(gen, 1, S, Hkv, d, dtype=dt).transpose(1, 2)
    pairs = S * (S + 1) // 2
    nb = (2 * Hq + 2 * Hkv) * S * d * es
    b, by = bound_ms(nb, 4 * pairs * Hq * d, dt)
    qc, kc2, vc2 = q.contiguous(), k.contiguous(), v.contiguous()
    rows["flash_attention"] = dict(
        shape=f"q (1,{Hq},{S},{d}), k/v (1,{Hkv},{S},{d}) bf16, causal",
        ms=time_ms(lambda: ops.flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc2, vc2, is_causal=True, enable_gqa=True)),
        device_us=kernel_device_us(device_profile(
            lambda: ops.flash_attention(q, k, v), 20)[0], "flash_kernel"),
        bound_ms=b, bound_by=by)
    for name, r in rows.items():
        log(f"  time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, device "
            f"(profiler) {r['device_us']:.2f} us, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    return rows


# ---------------------------------------------------------------------------
# phase 3: full-width serving
# ---------------------------------------------------------------------------


def serve_full_width():
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import (_unembed, decode_step, init_model,
                                          prefill_step)
    from repro_torch.serving import ServingEngine

    cfg = get_config("dcache-agent-150m")
    L = cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(cfg, gen, "cuda")
    log(f"  {cfg.name}: {cfg.param_count() / 1e6:.1f} M params, {cfg.dtype}, "
        f"L={L} d={cfg.d_model} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads}")
    # warm-up (cuBLAS handles, allocator) on a throw-away engine
    ServingEngine(cfg, params, max_batch=4, max_len=512,
                  device="cuda").generate_text(
        PROMPTS[0], max_new_tokens=4)
    torch.cuda.synchronize()

    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32) for p in PROMPTS]
    decode_only = []
    while eng.waiting or any(s is not None for s in eng.slots):
        n_pre = eng.prefills
        ts = time.perf_counter()
        eng.step()
        if eng.prefills == n_pre:
            decode_only.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    stats = eng.stats()
    text = TorchLLM(eng, max_new_tokens=32).complete(PROMPTS[1])
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    assert all(r.done for r in reqs) and eng.finished[-1].done, "unfinished"
    assert all(1 <= len(r.out_ids) <= 32 for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in eng.finished for t in r.out_ids)
    assert isinstance(text, str)
    expected = {"rmsnorm": (2 * L + 1) * (eng.prefills + eng.steps),
                "flash_attention": L * eng.prefills,
                "decode_attention": L * eng.steps}
    log(f"  prefills={eng.prefills} decode_steps={eng.steps} "
        f"launches={counts} expected={expected}")
    assert counts == expected, "launch counts differ from the main path's"
    gen_tokens = sum(len(r.out_ids) for r in reqs)
    m = dict(tokens=gen_tokens, wall_s=wall, tok_s=gen_tokens / wall,
             mean_ttft_ms=1e3 * stats["mean_ttft_s"],
             decode_step_ms=1e3 * statistics.median(decode_only),
             decode_steps_timed=len(decode_only))
    log(f"  serving: {gen_tokens} tokens in {wall:.3f} s = {m['tok_s']:.1f} tok/s, "
        f"mean TTFT {m['mean_ttft_ms']:.2f} ms, decode step (median of "
        f"{len(decode_only)}) {m['decode_step_ms']:.3f} ms; TorchLLM -> {text!r}")

    # where a step's time goes: device time by kernel and the busy share
    toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    prompt = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    lens = torch.tensor([60], dtype=torch.int32, device="cuda")
    for what, fn, table in (
            ("decode step (B=4)",
             lambda: decode_step(cfg, params, toks, eng.cache), "profile_decode_step.txt"),
            ("prefill (S=64)",
             lambda: prefill_step(cfg, params, {"tokens": prompt}, max_len=512,
                                  true_lens=lens), "profile_prefill.txt")):
        per_call, busy, wall_us = device_profile(fn, 10, table)
        dev_us = sum(per_call.values())
        top = sorted(per_call.items(), key=lambda kv: -kv[1])[:6]
        log(f"  profile {what}: host wall {wall_us / 1e3:.3f} ms/call, device "
            f"{dev_us / 1e3:.3f} ms/call, device busy {100 * busy:.1f}%; top: "
            + "; ".join(f"{k[:48]} {t:.1f} us" for k, t in top))
        key = "decode" if what.startswith("decode") else "prefill"
        m[f"{key}_wall_ms"] = wall_us / 1e3
        m[f"{key}_device_ms"] = dev_us / 1e3
        m[f"{key}_busy"] = busy

    # the unembed at a decode step: the bf16 GEMM with fp32 output against
    # an fp32 copy of the tied embedding (same accumulation, extra traffic)
    h = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda").to(cfg.torch_dtype)
    w = params["embed"].t()
    V = cfg.vocab_size
    err = (_unembed(cfg, params, h)[..., :V]
           - (h.float() @ w.float())[..., :V]).abs().max().item()
    assert err <= 1e-3, f"unembed differs from the fp32 product by {err:.3e}"
    m["unembed_device_us"] = sum(device_profile(
        lambda: _unembed(cfg, params, h), 20)[0].values())
    m["unembed_fp32_copy_device_us"] = sum(device_profile(
        lambda: h.float() @ w.float(), 20)[0].values())
    log(f"  unembed (4,1,{cfg.d_model}) x ({cfg.d_model},{cfg.padded_vocab}): "
        f"device {m['unembed_device_us']:.2f} us/call; with an fp32 copy of the "
        f"weight {m['unembed_fp32_copy_device_us']:.2f} us/call; "
        f"max |diff| {err:.3e} <= 1e-3")
    return counts, m


# ---------------------------------------------------------------------------
# phase 4: CPU (plain versions) against the card (kernels), fp32
# ---------------------------------------------------------------------------

def cpu_vs_card(tol=1e-3):
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_model, prefill_step
    from repro_torch.serving.tokenizer import ByteTokenizer

    cfg = dataclasses.replace(get_config("dcache-agent-150m"), n_layers=2,
                              dtype="float32")
    cpu_params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")

    def to_card(t):
        if isinstance(t, dict):
            return {k: to_card(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_card(v) for v in t]
        return t.to("cuda")

    gpu_params = to_card(cpu_params)
    tok = ByteTokenizer()
    ids = [tok.encode(p) for p in PROMPTS[:3]]
    S = max(len(i) for i in ids)
    toks = torch.tensor([i + [0] * (S - len(i)) for i in ids], dtype=torch.int32)
    lens = torch.tensor([len(i) for i in ids], dtype=torch.int32)
    c_cache, c_log = prefill_step(cfg, cpu_params, {"tokens": toks}, max_len=64,
                                  true_lens=lens)
    g_cache, g_log = prefill_step(cfg, gpu_params, {"tokens": toks.cuda()},
                                  max_len=64, true_lens=lens.cuda())
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
    log(f"  cpu vs card fp32 (2 layers, full width, 3 prompts, prefill + 8 "
        f"decode steps): max |logit diff| {worst:.3e} <= {tol}; "
        f"differing greedy tokens: {near_ties}")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"  built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_log.get('seconds', 0.0):.2f} s)")
    ptxas = str(_build.build_log.get("ptxas", ""))
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(ptxas)
    for line in ptxas.splitlines():
        if "Used" in line or "spill" in line:
            log("  " + line.strip())

    log("phase 2: kernels against their plain versions on the card")
    errs = {}
    check_kernels(errs)
    timing = time_kernels()

    log("phase 3: full-width serving")
    counts, serve = serve_full_width()

    log("phase 4: CPU vs card, fp32")
    cpu_vs_card()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card} | serving tok/s={serve['tok_s']:.1f} "
        f"mean_ttft_ms={serve['mean_ttft_ms']:.2f} "
        f"decode_step_ms={serve['decode_step_ms']:.3f}")
    src = {"rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:27"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:80"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:108")}
    kernels = [{"name": n, "route": "cuda", "source": src[n][0],
                "replaces": src[n][1], "launches": counts[n],
                "max_abs_err": errs[n], "ms": timing[n]["ms"],
                "plain_ms": timing[n]["plain_ms"],
                "bound_ms": timing[n]["bound_ms"],
                "bound_by": timing[n]["bound_by"],
                "library_ms": timing[n]["library_ms"]} for n in src]
    result = {"card": card, "serving": serve, "kernels": kernels}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
