#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from src/repro_torch/kernels/csrc/ and print the
     build time and each kernel's ptxas registers, shared memory and spills
     (any spill fails the run), the 12 attention instances at head dims
     16 and 32 (flash mma and fma, decode and int8 decode in bf16 and fp32)
     and the 12 WKV instances (prefill and decode, bf16 and fp32, head dims
     16, 32 and 64) by name;
  2. hold each kernel against its plain PyTorch version on the card, in bf16
     (atol = rtol = 2e-2) and fp32 (1e-4, sums in another order), at the main
     paths' shapes and ragged ones: flash and decode at every served
     path's (head dim, query heads, KV heads) of SERVED_PATHS and at d 96,
     G = 4; decode rings whose length is not a
     multiple of the split (C = 100) and whose splits are wholly masked or
     empty, windows that end inside a split, prompts whose packed rows cross
     the S*G edge, S = 512 (the engine's max_len); G = 16 at d 64; the int8
     decode kernel on rings of 64, 100 and 512 slots at G = 3 and 16 (d 64)
     and G = 1, 4 and 16 (d 96, 128), with windows, chunks, and a ring
     holding empty (scale 0) and prefill-pad (scale 1.0) slots; decode and
     int8 decode at groups cut into group tiles (G 40 and 64 over one KV
     head, G 40 over two, G 41 with a short last tile, at d 64 and 128;
     fp32 also G 32 and 21 at d 96 and 128); a head dim that is not built
     (80 for attention, 48 for WKV) must raise and launch nothing; rmsnorm
     at every served path's d_model and d 16 at 1, 4, 48, 64 and 257 rows,
     at d 100,
     on views off 16 bytes (its scalar path) and at qwen3-4b's
     qk_norm shapes (q (2,37,8,4,128), k (2,37,8,128)), its C++ launch
     geometry equal to kernels/rmsnorm.py's; WKV at head dims 64 (64
     heads), 16 (4) and 32 (8) around its staged chunk of T steps (T - 1,
     T, T + 1), at S = 512, from a random state and in place, its state
     bit-identical to the plain version's;
     flash at llava's heads (d 128, G 7) at its image request's length (S
     2,912) and at S 2,917, both ragged; prompts of S 32 (seamless's padded
     decoder prompt) and decode rings of 256 slots (seamless's
     cross-attention: the encoder's K/V of a cache layer, pos = C - 1) at
     every served head shape; flash and decode at head dims 16 and 32
     (SMALL_HEADS: G 1, 2 and 4, every mask, ragged S and C) and the int8
     kernel there at G 4, 2, 1 and 16. A misaligned view of an attention (bf16 or int8)
     or WKV input must raise and launch nothing. Time kernel, plain version and the library call
     (CUDA events, median of 50) at each served path's shapes (dcache,
     qwen3-4b, phi3-mini-3.8b, qwen1.5-32b's decode, mixtral's G 6,
     llama4's G 5 and llava's G 7 at d 128, seamless's MHA at d 64),
     prefill also at S = 512, llava's image prefill, seamless's encoder
     unmasked at its 256 frames, its cross-attention decode at C 256, the
     three attention kernels at head dims 16 and 32 at the reduced
     dcache's heads and the serving bench's shapes, decode at G 40 (d 128)
     and G 64 (d 64, also int8) in two group tiles, WKV and the per-head
     rmsnorm at the reduced rwkv6's head dim 16 (and WKV at 32), and an
     empty kernel (the launch floor);
  3. serve twelve paths at full width in bf16, each with random weights from
     a seeded torch.Generator, through ServingEngine(max_batch=4,
     max_len=512) (8 prompts x 32 new tokens) and then one
     TorchLLM.complete: dcache-agent-150m (dense: rmsnorm, prefill and
     decode attention), dcache-agent-150m with kv_quant (the int8 KV cache:
     every decode attention launch is the int8 kernel's), rwkv6-7b (ssm:
     rmsnorm and the WKV kernel), qwen3-4b (d 128, G 4, qk_norm on the
     rmsnorm kernel), granite-3-2b (d 64, G 4, tied), phi3-mini-3.8b (d 96,
     MHA), qwen1.5-32b (d 128, MHA, QKV bias; 70.4 GB of weights), then
     the MoE and hybrid families: mixtral-8x22b (d 128, G 6; 12 of its 56
     layers, width unchanged: 30.45 B parameters, 60.9 GB),
     llama4-maverick-400b-a17b (d 128, G 5; 4 of 48 layers, two dense/MoE
     super-layers, 128 experts and the shared one: 35.04 B parameters,
     70.1 GB) and hymba-1.5b (d 64, G 3, Mamba heads beside attention, full
     depth), then the encoder-decoder and the VLM: seamless-m4t-large-v2
     (24 + 24 layers, d 64 MHA; the engine does not take it, so 4 requests
     of 256 frames and a 16-32 token prompt go through
     launch.serve.generate_encdec: prefill_step, ring 512, and 32 greedy
     decode_steps; the encoder's attention on the flash kernel unmasked,
     cross-attention decode on the decode kernel) and llava-next-34b at
     full depth (d 128, G 7; 68.88 GB; text through the engine, then one
     image request: 2,880 patches before a 32-token prompt through
     prefill_step, ring 4,096, B 1, and 32 decode_steps, after the
     engine's cache is freed); each depth is fixed and asserted to fit the
     card's free memory (with llava's image ring) before anything is
     drawn. MoE and hybrid launch only the dense rule's
     kernels (the expert products and the SSM scan are torch ops, as they
     are XLA ops in JAX). The launch counters are reset before each path
     and must then equal the exact numbers the path implies. Profile a
     decode step, a prefill (each kernel's device time per launch in them,
     the launch API calls per call) and the unembed (held against an fp32
     product within 1e-3); record the KV cache's bytes on the card;
  paged: a full-width PagedKVCache for dcache-agent-150m filled from the
     engine's own prefill and decode steps (write_prompt, append): gather
     must equal the engine's ring bit for bit, fork_seq must share full
     pages and copy the tail, and paged_decode_attention (the decode kernel
     on the gathered view) must equal its plain version, with exact launch
     counts;
  assigned shapes: full-width dcache-agent-150m in bf16 at decode_32k (B
     128 over a ring of 32,768 slots drawn whole from a seeded generator, 3
     warm-up and 10 timed decode_steps, a profiled one; the step against
     analytic_hbm_bytes / 3.35 TB/s; layer 0's decode attention at this size
     against its plain version) and prefill_32k (B 32 x S 32,768 through
     prefill_step, the batch cut if its working set would not fit; flash's
     share of the profiled device time; one layer's flash against SDPA's
     time, one (row, head) of it against the plain version of that head);
     both holds absolute and, output row by output row, relative to the
     row's own rms (a long softmax's outputs are below the absolute
     tolerance); train_4k (B 256 x S 4,096, 1 M tokens a step) through
     TrainLoop with accumulated micro-batches: one 8 x 4,096 micro-batch's
     peak memory sets the smallest accumulation predicted to stay under 70
     GiB, which runs a warm-up and two timed steps (step ms, tokens/s,
     peak, model-FLOP share; one micro-batch profiled for its busy share);
     long_500k's skip text is logged;
  bench: repro_torch.launch.serving_bench's run_bench at its reference
     configuration (head dim 16) with its rows and exact launch counts, phase
     3's dcache workload 5 times in this process after a warm-up (median,
     min and max of tok/s, mean TTFT and decode step), bench_kernels' row;
  agent: the paper's own system on the card: full-width dcache-agent-150m
     in bf16 (ServingEngine(max_batch=4, max_len=512), 32 new tokens a
     decision) behind TorchLLM as LLMController's decision model for every
     read and update decision of 8 tasks of Table I's workload
     (build_tasks(8, reuse_rate=0.8, seed=1)), composed by hand from
     build_runtime's parts with SimLLM driving the runner, beside the same
     tasks without the cache; reports the decisions, each prompt's bytes
     and the bytes the engine kept, the median and maximum decision wall
     ms (synchronized), the parse fallbacks (an untrained byte-level model
     rarely writes JSON: the controller then takes the programmatic plan)
     and degraded calls, the cache's hits and the sim-clock avg_time_s of
     both runs and their ratio; the phase's launch counts exactly those of
     the engine's prefills and steps; then the port's Tables I-III
     (table1(n=40), table2(n=30), table3(n=30)) on the card's host against
     the digests that lock the reference;
  concurrent: the paper's deployment regime on the card: the port's
     ConcurrentEpisodeEngine (8 sessions x 5 tasks over 4 pods of capacity
     5, TinyLFU admission and hot-key replication both GPT-driven, zipf
     1.1 with a global ranking: table_replication's headline cell cut to 8
     sessions) with one DecisionLog-wrapped TorchLLM over full-width
     dcache-agent-150m in bf16 (ServingEngine(max_batch=4, max_len=512),
     32 new tokens a decision) set as the admission and the replication
     policies' LLM after construction (the sessions' runners keep their
     SimLLMs), beside the same episode with the engine's own SimLLM planes
     (34 admission and 8 replication decisions); reports the decisions by
     plane, each prompt's bytes and the bytes the engine kept, the median
     and maximum decision wall ms (synchronized), each plane's parse
     fallbacks and degraded calls, and both runs' sim-clock p50 and p95
     task latency, local hit rate, replication agreement and stall; the
     phase's launch counts exactly those of the engine's prefills and
     steps; then the digest-locked concurrent tables (table_concurrency,
     table_prefetch, table_admission, table_replication at 25 tasks a
     session, belady_bound(200), table_resilience(12) with an empty
     MutationPlan) on the card's host;
  4. for the first three paths, qwen3-4b, phi3-mini-3.8b, qwen1.5-32b,
     mixtral-8x22b (MoE, G 6), hymba-1.5b (attention and Mamba heads),
     seamless-m4t-large-v2 (64 frames a prompt) and llava-next-34b (16
     patches before each prompt): every head dim and group of phase 3 but
     llama4's G 5, the full-width weights cut to 2 layers, in fp32,
     on the CPU (plain versions) and on the card (kernels): prefill + 8
     greedy decode steps on 3 prompts; logits within 1e-3 and the same greedy
     tokens (or a top-2 gap within the tolerance where a token differs); the
     int8 codes may differ by one where a value lies on a rounding edge.
     Attention prompts are right-padded with true_lens; rwkv and hymba
     prompts are prefilled one by one at their own length, since padding
     would enter the recurrent state. llama4-maverick is left out: one
     super-layer at full width is 74 GB of fp32 weights on the host; its
     heads are held in phase 2 and its numerics against JAX on the CPU
     (tests/test_torch_moe.py). Then the reduced configs (head dim 16,
     vocab 512) of every family the same way (REDUCED_ARCHS: dcache, rwkv6
     (WKV at head dim 16), the four dense variants, mixtral, llama4,
     hymba, seamless and llava; a prompt longer than a window's ring
     prefilled at its own length); the reduced dcache in fp32 as the cache
     controller's decision model for 2 tasks on the CPU and on the card
     (the same completions and TaskTraces, the card's launch counts
     exact); the same reduced dcache behind the concurrent engine's
     admission and replication planes in episodes of 2 x 2 and 3 x 2 tasks
     over 2 pods of capacity 2 on the CPU and on the card (the same
     completions and EpisodeMetrics row, the card's launch counts exact);
     and launch.serve's --smoke main (dcache,
     and --arch rwkv6-7b) and launch.serve_llm's on the card, held to the
     launch counts of the engines they return;
  5. training (freeing the card before and after): full-width
     dcache-agent-150m in bf16 through the twin's own train() of
     repro_torch.launch.serve_llm, 30 AdamW steps at 8 x 512 tokens; every
     loss and grad_norm finite, the loss down by at least 0.5 (mean of the
     last 5 against the first 5), no kernel launched in training, the
     same 30 steps with remat="dots" beside them (step ms, peak memory,
     every loss within 1e-3 relative), the
     params bf16 without grad after it; those params then serve the twin's 8
     prompts through its serve() with the launch counts of phase 3's rule,
     and one TorchLLM decision. Reports the median step, tokens/s, peak
     memory, the launch API calls and busy share of 3 profiled steps, and
     the model-FLOP share of the bf16 peak. Then one make_train_step step
     at fp32, 2 layers of full width, on the CPU and on the card, for
     dcache-agent-150m (B 2, S 64) and rwkv6-7b (B 1, S 32): the loss within
     1e-4 relative, grad_norm within 1e-3;
  6. checkpoints (freeing the card before and after): full-width
     dcache-agent-150m in bf16 trained through repro_torch.launch.train
     (--preset full, 8 x 512, 4 steps, no kernel launched) with exactly one
     save, at the end (the reference's format: msgpack records, zlib where
     zstandard is absent, blake2b digests); a cold restart with --resume on
     the card and another on the CPU, each equal to the saved params (bf16),
     moments (fp32) and step bit for bit; the restored weights serve the
     twin's 8 prompts with phase 3's launch rule and the same tokens as the
     saved ones; then repro_torch.launch.train_tiny on the card (reduced
     qwen3-4b, 60 steps, two failures recovered from disk, a cold restart).
     Reports bytes on disk, the codec, the save's seconds and MB/s (the
     JAX-layout stack on the card, timed again on the saved state, plus the
     checkpointer's copy to the host and write) and each cold restart's
     (the whole of building the loop with --resume, and the checkpointer's
     host read within it);
  7. print the card's name and power limit and the kernels' JSON line, then
     the result line.

It imports nothing of JAX or of the JAX package ``repro``. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

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
# calls per profiled step or prefill: the profiler's own processing of
# every launch is most of a host-bound path's phase 3 time (each profile
# logs its seconds), and a step's device time varies < 3% between calls
PROFILE_ITERS = 3
# each wrapper's kernel names in the profiler (a substring of each instance)
KERNEL_NEEDLES = {"rmsnorm": "rmsnorm_kernel", "flash_attention": "flash_kernel",
                  "decode_attention": "decode_kernel",
                  "decode_attention_int8": "decode_int8_kernel",
                  "wkv": "wkv_kernel"}


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


def device_profile(fn, iters, table_file=None, warmup=True):
    """torch.profiler over ``iters`` calls of fn (after one more unless
    ``warmup`` is False): device time per call by kernel name (us), the
    device-busy share of the host wall time, the host wall time per call
    (us) and the launch API calls per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_call, n_launch = {}, 0
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            per_call[a.key] = (per_call.get(a.key, 0.0)
                               + a.self_device_time_total / iters)
        elif a.key in LAUNCH_APIS:
            n_launch += a.count
    if table_file:
        with open(os.path.join(OUT_DIR, table_file), "w") as f:
            f.write(prof.key_averages().table(row_limit=60))
    return (per_call, sum(per_call.values()) * iters / wall_us, wall_us / iters,
            n_launch / iters)


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
        t0 = time.perf_counter()
        check_group_tiles(gen, dtype, errs)
        log(f"  group tiles {str(dtype)[6:]}: {time.perf_counter() - t0:.1f} s")
        for d in HEAD_DIMS:
            check_int8(gen, dtype, d, errs)
        check_misaligned(gen, dtype)
        check_refused(gen, dtype)
    t0 = time.perf_counter()
    check_wkv(errs)
    log(f"  wkv at head dims {sorted(hd for hd, _ in WKV_HEADS)}: "
        f"{time.perf_counter() - t0:.1f} s")


def check_attention(gen, dtype, d, Hq, Hkv, errs):
    """Flash and decode attention at head dim d and group Hq / Hkv: prompts
    of S = 8..512 whose packed rows (S * G) cross a 64-row tile's edge,
    under causal, window, chunk and no mask; decode rings of 64, 100 (not a
    multiple of the 8 splits, the last range short), 256 (seamless's
    cross-attention ring of encoder frames at pos = C - 1) and 512 slots (pos in
    {0, 1, 63, 64}: whole splits masked or empty), with windows and chunks
    and a window that ends inside a split."""
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


def check_misaligned(gen, dtype):
    """A view offset by one element must raise before any launch: the
    attention and WKV kernels copy 16-byte rows."""
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
    before = ops.launch_counts()
    for name, call in (
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
    assert ops.launch_counts() == before, "a misaligned view launched a kernel"


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
    before = ops.launch_counts()
    calls = [("flash_attention", ValueError, lambda: ops.flash_attention(q, k, k)),
             ("decode_attention", ValueError,
              lambda: ops.decode_attention(q[:, :, 0], k, k, p)),
             ("decode_attention_int8", ValueError, lambda: ops.decode_attention_int8(
                 q[:, :, 0].contiguous(), codes, codes, scales, scales, p))]
    r = randn(gen, 1, 8, 2, 48, dtype=dtype)
    w = torch.full((1, 8, 2, 48), 0.9, device="cuda")
    calls.append(("wkv", ValueError,
                  lambda: ops.wkv(r, r, r, w, randn(gen, 2, 48, dtype=dtype))))
    for name, exc, call in calls:
        try:
            call()
        except exc as e:
            log(f"  {name} refused {str(dtype)[6:]}: raised ({e})")
        else:
            raise AssertionError(f"{name}: an unbuilt shape did not raise")
    assert ops.launch_counts() == before, "a refused shape launched a kernel"


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


def time_decode(gen, B, Hq, Hkv, C, d, int8=False, pos=None):
    """Decode attention (or its int8 variant) in bf16 at a decode step over
    a full ring of C slots (``pos`` (B,) given, or past the ring's end):
    kernel, plain version, SDPA (bf16 only), the kernel's profiled device
    time and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import (
        decode_attention_int8_plain, decode_attention_plain, group_tiles,
        max_heads, split_geometry)

    dt, es = torch.bfloat16, 2
    n_gt, gt = group_tiles(Hq // Hkv, max_heads(dt, d, int8=int8))
    q = randn(gen, B, Hq, d, dtype=dt)
    pos = torch.tensor(pos or [C + 3, C + 40, 2 * C + 5, 3 * C][:B],
                       dtype=torch.int32, device="cuda")
    valid = sum(min(int(p) + 1, C) for p in pos)
    n_split, per = split_geometry(C)
    if int8:
        _, _, k, ks = int8_ring(gen, B, C, Hkv, d, dt)
        _, _, v, vs = int8_ring(gen, B, C, Hkv, d, dt)
        # q read and out written in bf16, one byte a code, es bytes a scale
        nb = 2 * q.numel() * es + 2 * valid * Hkv * (d + es) + pos.numel() * 4
        run = lambda: ops.decode_attention_int8(q, k, v, ks, vs, pos)  # noqa: E731
        plain = lambda: decode_attention_int8_plain(q, k, v, ks, vs, pos)  # noqa: E731
        shape = (f"q ({B},{Hq},{d}) bf16, int8 cache ({B},{C},{Hkv * d}) + bf16 "
                 f"scales ({B},{C},{Hkv}), full ring; grid ({n_split},"
                 f"{Hkv * n_gt},{B}), {n_gt} group tile(s) of {gt} heads")
        lib_ms = lib_us = None
    else:
        kc = randn(gen, B, C, Hkv * d, dtype=dt)
        vc = randn(gen, B, C, Hkv * d, dtype=dt)
        k = kc.view(B, C, Hkv, d).transpose(1, 2)
        v = vc.view(B, C, Hkv, d).transpose(1, 2)
        nb = (2 * q.numel() + 2 * valid * Hkv * d) * es + pos.numel() * 4
        run = lambda: ops.decode_attention(q, k, v, pos)  # noqa: E731
        plain = lambda: decode_attention_plain(q, k, v, pos)  # noqa: E731
        shape = (f"q ({B},{Hq},{d}), cache ({B},{C},{Hkv * d}) bf16, full ring; "
                 f"grid ({n_split},{Hkv * n_gt},{B}), clusters of {n_split}, {per} "
                 f"slots each, {n_gt} group tile(s) of {gt} heads")
        kk, vv, qq = k.contiguous(), v.contiguous(), q[:, :, None]
        mask = torch.ones((B, 1, 1, C), dtype=torch.bool, device="cuda")
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, attn_mask=mask, enable_gqa=True)
        lib_ms, lib_us = time_ms(sdpa), all_device_us(sdpa)
    b, by = bound_ms(nb, 4 * valid * Hq * d, dt)
    needle = "decode_int8_kernel" if int8 else "decode_kernel"
    return dict(shape=shape, ms=time_ms(run), plain_ms=time_ms(plain),
                library_ms=lib_ms, library_device_us=lib_us,
                device_us=kernel_device_us(device_profile(run, 20)[0], needle),
                bound_ms=b, bound_by=by)


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
        log(f"  time {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, device "
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
    prefill included."""
    L, n = cfg.n_layers, prefills + steps
    if cfg.family == "ssm":
        return {"rmsnorm": (3 * L + 1) * n, "flash_attention": 0,
                "decode_attention": 0, "decode_attention_int8": 0, "wkv": L * n}
    if cfg.is_encdec:
        Le = cfg.n_encoder_layers
        return {"rmsnorm": (2 * Le + 1) * prefills + (3 * L + 1) * n,
                "flash_attention": (Le + L) * prefills,
                "decode_attention": 2 * L * steps, "decode_attention_int8": 0,
                "wkv": 0}
    decode = "decode_attention_int8" if cfg.kv_quant else "decode_attention"
    norms = 4 if cfg.qk_norm else 2
    out = {"rmsnorm": (norms * L + 1) * n, "flash_attention": L * prefills,
           "decode_attention": 0, "decode_attention_int8": 0, "wkv": 0}
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


def decode_read_bytes(cfg, rows=4):
    """The weight bytes a decode step of ``rows`` tokens must read: every
    leaf but the frontend's projection and the encoder (run at prefill
    only), and of an untied input embedding only the rows it gathers."""
    from repro_torch.bridge import _dict_map, param_shapes
    from repro_torch.launch.serve import weight_bytes

    es = torch.empty((), dtype=cfg.torch_dtype).element_size()
    skip = {k: v for k, v in param_shapes(cfg).items()
            if k in ("enc", "frame_proj", "patch_proj")}
    nbytes = weight_bytes(cfg) - es * sum(tree_leaves(_dict_map(math.prod, skip)))
    if not cfg.tie_embeddings:
        nbytes -= (cfg.padded_vocab - rows) * cfg.d_model * es
    return nbytes


def load_path(arch, kv_quant=False, n_layers=None, extra_bytes=0):
    """``arch`` (depth cut to ``n_layers`` if given) with seeded random bf16
    weights on the card, after asserting that they, the engine's cache and
    ``extra_bytes`` fit its free memory. Returns (cfg, params, generator,
    metrics)."""
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
    t0 = time.perf_counter()
    params = init_model(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    # a decode step cannot read its weights faster than the card's memory
    # rate; the MoE dispatch reads every expert at every step
    m = dict(arch=arch, kv_quant=kv_quant, params=n_params,
             init_s=time.perf_counter() - t0, n_layers=cfg.n_layers,
             full_layers=full.n_layers, free_bytes=free,
             weights_read_floor_ms=1e3 * decode_read_bytes(cfg) / PEAK_BYTES_S)
    log(f"  {cfg.name}: {n_params / 1e6:.1f} M params summed from the tensors "
        f"({cfg.param_count() / 1e6:.1f} M by ModelConfig.param_count), "
        f"{cfg.dtype}, L={cfg.n_layers} d={cfg.d_model}, family {cfg.family}; "
        f"init {m['init_s']:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated")
    return cfg, params, gen, m


def profile_path(cfg, m, tag, cases):
    """Where a step's time goes: for each (key, label, fn, iters) of
    ``cases`` the device time by kernel, the busy share, the launch API
    calls and each kernel's launches and device time per launch, into
    ``m`` under ``key``; the profiler's table into chiprun_out/."""
    from repro_torch.kernels import ops

    for key, what, fn, iters in cases:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        per_call, busy, wall_us, api_launches = device_profile(
            fn, iters, f"profile_{tag}_{'decode_step' if key == 'decode' else key}.txt")
        m[f"{key}_profile_s"] = time.perf_counter() - t0
        # device_profile calls fn once to warm up, then iters times
        launches = {k: v / (iters + 1)
                    for k, v in ops.launch_counts().items() if v}
        dev_us = sum(per_call.values())
        top = sorted(per_call.items(), key=lambda kv: -kv[1])[:6]
        # each kernel's device time per launch inside the step or prefill
        in_step = {n: kernel_device_us(per_call, KERNEL_NEEDLES[n]) / c
                   for n, c in launches.items()}
        if key == "decode" and (cfg.family in ("moe", "encdec", "vlm")):
            log(f"  decode step device {dev_us / 1e3:.3f} ms against the "
                f"weights-read floor {m['weights_read_floor_ms']:.3f} ms "
                f"({decode_read_bytes(cfg) / 1e9:.2f} GB at 3.35 TB/s)")
        log(f"  profile {what} ({iters} calls, {m[f'{key}_profile_s']:.1f} s "
            f"with the profiler's processing): host wall {wall_us / 1e3:.3f} ms/call, device "
            f"{dev_us / 1e3:.3f} ms/call, device busy {100 * busy:.1f}%; "
            f"launch API calls/call {api_launches:.1f}; "
            f"kernel launches/call {launches}; device us per launch "
            + ", ".join(f"{n} {t:.2f}" for n, t in in_step.items()) + "; top: "
            + "; ".join(f"{k[:48]} {t:.1f} us" for k, t in top))
        m[f"{key}_per_launch_us"] = in_step
        m[f"{key}_wall_ms"] = wall_us / 1e3
        m[f"{key}_device_ms"] = dev_us / 1e3
        m[f"{key}_busy"] = busy
        m[f"{key}_launch_api_calls"] = api_launches
        m[f"{key}_top_us"] = dict(top)


def check_unembed(cfg, params, gen, m):
    """The unembed at a decode step: the bf16 GEMM with fp32 output against
    an fp32 copy of the weight (same accumulation, extra traffic)."""
    from repro_torch.models.model import _unembed

    h = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda").to(cfg.torch_dtype)
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
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


def image_ring_bytes(cfg):
    """What llava's image request holds on the card beyond the weights: its
    ring of IMAGE_MAX_LEN slots twice (the layers' rings and their stack)."""
    from repro_torch.configs import alloc_cache

    return 2 * cache_bytes(alloc_cache(cfg, 1, IMAGE_MAX_LEN, torch.device("meta")))


def serve_workload(eng, n_new=32):
    """Phase 3's workload on ``eng``: the 8 PROMPTS of ``n_new`` tokens
    each, served to completion. Returns the generated tokens, the wall
    time, tokens/s, the mean TTFT and the median decode-only step (host
    clock; a step ends when its sampled tokens reach the host)."""
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in PROMPTS]
    decode_only = []
    while eng.waiting or any(s is not None for s in eng.slots):
        n_pre = eng.prefills
        ts = time.perf_counter()
        eng.step()
        if eng.prefills == n_pre:
            decode_only.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    assert all(r.done and 1 <= len(r.out_ids) <= n_new for r in reqs), "unfinished"
    n = sum(len(r.out_ids) for r in reqs)
    ttft = statistics.fmean(r.first_token_at - r.submitted_at for r in reqs)
    return dict(tokens=n, wall_s=wall, tok_s=n / wall, mean_ttft_ms=1e3 * ttft,
                decode_step_ms=1e3 * statistics.median(decode_only),
                decode_steps_timed=len(decode_only))


def serve_full_width(arch, kv_quant=False, n_layers=None):
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import alloc_cache, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.serving import ServingEngine

    full = get_config(arch)
    vlm = full.frontend == "vision_patches"
    cfg, params, gen, m = load_path(arch, kv_quant, n_layers, extra_bytes=(
        image_ring_bytes(full) if vlm else 0))
    # warm-up (cuBLAS handles, allocator) on a throw-away engine
    ServingEngine(cfg, params, max_batch=4, max_len=512,
                  device="cuda").generate_text(PROMPTS[0], max_new_tokens=4)
    torch.cuda.synchronize()

    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    if cfg.family != "ssm":
        # the KV cache on the card, against the bf16 ring of the same engine
        bf16 = alloc_cache(dataclasses.replace(cfg, kv_quant=False), 4, 512,
                           torch.device("meta"))
        m.update(kv_cache_bytes=cache_bytes(eng.cache),
                 kv_cache_bytes_bf16=cache_bytes(bf16))
        log(f"  KV cache on the card: {m['kv_cache_bytes'] / 2**20:.3f} MiB "
            f"({'int8 codes + scales' if kv_quant else cfg.dtype}); the "
            f"{cfg.dtype} ring: {m['kv_cache_bytes_bf16'] / 2**20:.3f} MiB")
        if kv_quant:
            assert eng.cache["k"].dtype == torch.int8 and "k_scale" in eng.cache
    ops.reset_launch_counts()
    w = serve_workload(eng)
    text = TorchLLM(eng, max_new_tokens=32).complete(PROMPTS[1])
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    assert eng.finished[-1].done, "unfinished"
    assert all(0 <= t < cfg.vocab_size for r in eng.finished for t in r.out_ids)
    assert isinstance(text, str)
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    log(f"  prefills={eng.prefills} decode_steps={eng.steps} "
        f"launches={counts} expected={expected}")
    assert counts == expected, "launch counts differ from the main path's"
    m.update(w, prefills=eng.prefills, steps=eng.steps, launches=counts)
    log(f"  serving: {w['tokens']} tokens in {w['wall_s']:.3f} s = "
        f"{w['tok_s']:.1f} tok/s, mean TTFT {w['mean_ttft_ms']:.2f} ms, decode "
        f"step (median of {w['decode_steps_timed']}) {w['decode_step_ms']:.3f} "
        f"ms; TorchLLM -> {text!r}")

    # Attention prompts are padded to a bucket (64 here); rwkv and hymba
    # prompts run at their exact length (48 here, about that of PROMPTS).
    toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    if cfg.family in ("ssm", "hybrid"):
        prompt = torch.zeros((1, 48), dtype=torch.int32, device="cuda")
        pre_kw = {}
    else:
        prompt = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
        pre_kw = {"true_lens": torch.tensor([60], dtype=torch.int32, device="cuda")}
    tag = arch.split("-")[0] + ("_kvq" if kv_quant else "")
    profile_path(cfg, m, tag, (
        ("decode", "decode step (B=4)",
         lambda: decode_step(cfg, params, toks, eng.cache), PROFILE_ITERS),
        ("prefill", f"prefill (S={prompt.shape[1]})",
         lambda: prefill_step(cfg, params, {"tokens": prompt}, max_len=512,
                              **pre_kw), PROFILE_ITERS)))
    check_unembed(cfg, params, gen, m)
    if vlm:
        del eng
        free_card()
        c = image_request(cfg, params, gen, m)
        counts = {k: counts[k] + c[k] for k in counts}
    return counts, m


def image_request(cfg, params, gen, m):
    """llava's image request: 2,880 patch embeddings before a 32-token
    prompt through prefill_step (B 1, a ring of 4,096 slots) and 32 greedy
    decode_steps, with the dense rule's launch counts; then a profile of
    the image prefill and of a decode step on its ring."""
    from repro_torch.kernels import ops
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
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = prefill_step(cfg, params, batch, max_len=IMAGE_MAX_LEN)
    nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    first = int(nxt)
    ttft = time.perf_counter() - t0
    out, steps_s = [first], []
    for _ in range(32):
        ts = time.perf_counter()
        logits, cache = decode_step(cfg, params, nxt, cache)
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        out.append(int(nxt))
        steps_s.append(time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expected = expected_launches(cfg, 1, 32)
    S = P + len(ids)
    assert int(cache["pos"][0]) == S + 32, cache["pos"]
    assert tuple(cache["k"].shape) == (cfg.n_layers, 1, IMAGE_MAX_LEN,
                                       cfg.n_kv_heads * cfg.head_dim_)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    assert all(0 <= t < cfg.vocab_size for t in out)
    log(f"  image request: {P} patches + {len(ids)} tokens (S {S}) in a ring "
        f"of {IMAGE_MAX_LEN}, 32 decode steps: TTFT {1e3 * ttft:.2f} ms, decode "
        f"step (median) {1e3 * statistics.median(steps_s):.3f} ms, "
        f"{33 / wall:.1f} tok/s; launches={counts} expected={expected}")
    assert counts == expected, "image request's launch counts differ"
    m.update(image_ttft_ms=1e3 * ttft, image_decode_step_ms=1e3 * statistics.median(
        steps_s), image_tok_s=33 / wall, image_launches=counts, image_s=S)
    toks = nxt
    profile_path(cfg, m, "llava", (
        ("image_prefill", f"image prefill (S={S})",
         lambda: prefill_step(cfg, params, batch, max_len=IMAGE_MAX_LEN), 3),
        ("image_decode", f"decode step on the image ring (B=1, C={IMAGE_MAX_LEN})",
         lambda: decode_step(cfg, params, toks, cache), PROFILE_ITERS)))
    return counts


def serve_encdec(arch):
    """seamless at full width: 4 requests of 256 frames and a 16-32 token
    decoder prompt each through ``launch.serve.generate_encdec``
    (prefill_step with a ring of 512, then 32 greedy decode_steps) with
    exact launch counts; then profiles of a decode step and a prefill."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate_encdec
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.serving.tokenizer import ByteTokenizer

    cfg, params, gen, m = load_path(arch)
    tok = ByteTokenizer()
    ids = [tok.encode(PROMPTS[i])[:n] for i, n in zip((0, 2, 4, 5),
                                                      (16, 21, 26, 32))]
    frames = torch.randn((4, ENC_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.torch_dtype)
    generate_encdec(cfg, params, ids, frames, 512, 2)       # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate_encdec(cfg, params, ids, frames, 512, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expected = expected_launches(cfg, 1, 32)
    assert tuple(out.shape) == (4, 33)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    log(f"  4 requests ({[len(i) for i in ids]} tokens, {ENC_FRAMES} frames "
        f"each) + 32 greedy steps: {4 * 33} tokens in {wall:.3f} s = "
        f"{4 * 33 / wall:.1f} tok/s; first row -> {tok.decode(out[0].tolist())!r}; "
        f"launches={counts} expected={expected}")
    assert counts == expected, "launch counts differ from the main path's"

    S = max(len(i) for i in ids)
    batch = {"tokens": torch.tensor([i + [0] * (S - len(i)) for i in ids],
                                    dtype=torch.int32, device="cuda"),
             "frames": frames}
    lens = torch.tensor([len(i) for i in ids], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        ts = time.perf_counter()
        cache, _ = prefill_step(cfg, params, batch, max_len=512, true_lens=lens)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - ts
        toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
        steps_s = []
        for _ in range(16):
            ts = time.perf_counter()
            decode_step(cfg, params, toks, cache)
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - ts)
    m.update(tokens=4 * 33, wall_s=wall, tok_s=4 * 33 / wall,
             mean_ttft_ms=1e3 * ttft, decode_step_ms=1e3 * statistics.median(steps_s),
             decode_steps_timed=len(steps_s), prefills=1, steps=32,
             launches=counts, kv_cache_bytes=cache_bytes(cache))
    log(f"  prefill of the 4 requests {1e3 * ttft:.2f} ms, decode step (median "
        f"of 16) {m['decode_step_ms']:.3f} ms; cache on the card (ring and "
        f"cross K/V) {m['kv_cache_bytes'] / 2**20:.3f} MiB")
    profile_path(cfg, m, "seamless", (
        ("decode", "decode step (B=4)",
         lambda: decode_step(cfg, params, toks, cache), PROFILE_ITERS),
        ("prefill", f"prefill (B=4, {ENC_FRAMES} frames, S={S})",
         lambda: prefill_step(cfg, params, batch, max_len=512, true_lens=lens),
         PROFILE_ITERS)))
    check_unembed(cfg, params, gen, m)
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
    from repro_torch.kernels import ops
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
    ops.reset_launch_counts()
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
    counts = ops.launch_counts()
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
    past the ring's end), the ring drawn from ``gen`` layer by layer. 3
    warm-up and 10 timed decode_steps (CUDA events), one profiled step;
    then one layer's decode attention at this size against its plain
    version, 16 rows at a time."""
    from repro_torch.configs import DECODE_32K, input_specs
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import analytic_hbm_bytes
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
    torch.cuda.synchronize()
    step = lambda: decode_step(cfg, params, tokens, cache)  # noqa: E731
    ops.reset_launch_counts()
    with torch.no_grad():
        for _ in range(3):
            step()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(10)]
        for a, b in ev:
            a.record()
            logits, _ = step()
            b.record()
        torch.cuda.synchronize()
        per_call, busy, wall_us, _ = device_profile(
            step, 1, "profile_dcache_decode_32k.txt", warmup=False)
    counts = ops.launch_counts()
    expected = expected_launches(cfg, 0, 14)
    log(f"  decode_32k launches={counts} expected={expected}")
    assert counts == expected, "decode_32k launch counts differ"
    assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
    step_ms = statistics.median(a.elapsed_time(b) for a, b in ev)
    dev_ms = sum(per_call.values()) / 1e3
    dec_us = kernel_device_us(per_call, "decode_kernel") / L
    hbm = analytic_hbm_bytes(cfg, shape, 1)
    bound = 1e3 * hbm / PEAK_BYTES_S
    # the decode kernel's own bytes: the whole ring of a layer, q and out
    ring = 2 * B * S * cfg.n_kv_heads * cfg.head_dim_ * 2
    m["decode_32k"] = dict(
        B=B, C=S, step_ms=step_ms, device_ms=dev_ms, busy=busy,
        host_wall_ms=wall_us / 1e3, decode_kernel_us=dec_us,
        decode_kernel_bound_us=1e6 * ring / PEAK_BYTES_S,
        analytic_hbm_bytes=hbm, bound_ms=bound, share_of_bound=bound / step_ms,
        launches=counts)
    log(f"  decode_32k (B {B}, ring {S}, bf16): step {step_ms:.3f} ms (CUDA "
        f"events, median of 10 after 3 warm-up), device {dev_ms:.3f} ms "
        f"(profiled step, busy {100 * busy:.1f}%), decode kernel "
        f"{dec_us:.1f} us a launch (its ring read {ring / 1e9:.3f} GB: "
        f"{1e6 * ring / PEAK_BYTES_S:.1f} us at 3.35 TB/s); bound "
        f"analytic_hbm_bytes {hbm / 1e9:.3f} GB / 3.35 TB/s = {bound:.3f} ms, "
        f"the step at {100 * bound / step_ms:.1f}% of it")
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
    where its working set would not fit), timed with CUDA events and then
    profiled once; flash's share of the device time. Then flash on one
    layer's q (drawn), k and v (the prefilled cache's layer 0) against
    SDPA's time on the same inputs, and one (row, head) of its output held
    against the plain version of that head alone (a full plain version
    would need 1.6 TB of scores)."""
    import torch.nn.functional as F

    from repro_torch.configs import PREFILL_32K, alloc_cache, input_specs
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import analytic_hbm_bytes
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
    run = lambda: prefill_step(cfg, params, {"tokens": tokens})  # noqa: E731
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        cache, logits = run()
        b.record()
        torch.cuda.synchronize()
        prefill_ms = a.elapsed_time(b)
        assert int(cache["pos"][0]) == S and tuple(cache["k"].shape) == (
            L, B, S, cfg.n_kv_heads * cfg.head_dim_)
        assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
        k0, v0 = cache["k"][0].clone(), cache["v"][0].clone()
        del cache, logits
        per_call, busy, _, _ = device_profile(
            run, 1, "profile_dcache_prefill_32k.txt", warmup=False)
    peak = torch.cuda.max_memory_allocated()
    counts = ops.launch_counts()
    expected = expected_launches(cfg, 2, 0)
    log(f"  prefill_32k launches={counts} expected={expected}")
    assert counts == expected, "prefill_32k launch counts differ"
    dev_ms = sum(per_call.values()) / 1e3
    flash_ms = kernel_device_us(per_call, "flash_kernel") / 1e3
    hbm = analytic_hbm_bytes(cfg, dataclasses.replace(shape, global_batch=B), 1)
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
        B=B, S=S, batch_cut=cut, prefill_ms=prefill_ms, device_ms=dev_ms,
        busy=busy, flash_device_ms=flash_ms, flash_share=flash_ms / dev_ms,
        peak_bytes=peak, analytic_hbm_bytes=hbm,
        bound_ms=1e3 * hbm / PEAK_BYTES_S, flash_layer_ms=fl_ms,
        sdpa_layer_ms=sdpa_ms, flash_layer_bound_ms=fl_bound,
        flash_layer_bound_by=fl_by, max_row_rel_err=row_rel,
        last_rows_rel_err=late_rel, launches=counts)
    log(f"  prefill_32k (B {B} x S {S}, bf16): prefill {prefill_ms:.1f} ms (CUDA "
        f"events), device {dev_ms:.1f} ms (profiled, busy {100 * busy:.1f}%), "
        f"flash {flash_ms:.1f} ms of it ({100 * flash_ms / dev_ms:.1f}%); peak "
        f"memory {peak / 2**30:.2f} GiB; analytic_hbm_bytes {hbm / 1e9:.2f} GB "
        f"= {1e3 * hbm / PEAK_BYTES_S:.2f} ms at 3.35 TB/s; one layer's flash "
        f"{fl_ms:.2f} ms, SDPA {sdpa_ms:.2f} ms, bound {fl_bound:.2f} ms ({fl_by})")
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
    dividing 256 whose peak stays under 70 GiB. That N takes one warm-up
    step and two timed ones (host clock around each TrainLoop step, which
    ends on the loss; each step's peak memory). Then one micro-batch of
    that N under the profiler: its device time, busy share and launch API
    calls (a whole step's are N of them and AdamW's). Every loss and
    grad_norm finite, the first loss within 0.5 of ln(vocab) (random
    weights), and no kernel launched: training takes the eager path."""
    from repro_torch.configs import TRAIN_4K, input_specs
    from repro_torch.distributed import HeartbeatMonitor
    from repro_torch.kernels import ops
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
    n_params = sum(t.numel() for t in tree_leaves(params))
    flops = train_flops(cfg, n_params, B, S)
    before = ops.launch_counts()

    def loop_for(n):
        return TrainLoop(cfg, opt, params, itertools.repeat(batch),
                         accum_steps=n, monitor=HeartbeatMonitor())

    def peak_of(fn):
        """(fn's result, the memory held before it, its peak)."""
        free_card()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, base, torch.cuda.max_memory_allocated()

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
    steps_ms = [1e3 * t for t in loop.monitor.step_times]
    rows = B // n
    per_call, busy, wall_us, api = device_profile(
        lambda: loss_and_grads(cfg, loop.params,
                               {k: v[:rows] for k, v in batch.items()}),
        1, "profile_dcache_train_4k_micro.txt", warmup=False)
    losses = [loss0] + loop.history
    gnorms = [x["grad_norm"] for x, _, _ in steps]
    peak = max(p for _, _, p in steps)
    assert ops.launch_counts() == before, "train_4k launched a hand-written kernel"
    assert all(map(math.isfinite, losses + gnorms)), "a loss or grad_norm is not finite"
    ln_v = math.log(cfg.vocab_size)
    assert abs(loss0 - ln_v) <= 0.5, f"first loss {loss0:.3f}, ln(vocab) {ln_v:.3f}"
    step_ms = statistics.median(steps_ms[1:])
    tok_s = B * S / (step_ms / 1e3)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    dev_ms = sum(per_call.values()) / 1e3
    m["train_4k"] = dict(
        B=B, S=S, accum=n, micro_batch=rows, first_accum=TRAIN4K_FIRST_ACCUM,
        first_micro_peak_bytes=peak0, base_bytes=base,
        predicted_peak_bytes=predicted, peak_bytes=peak,
        step_peak_bytes=[p for _, _, p in steps], step_ms_all=steps_ms,
        step_ms=step_ms, tok_s=tok_s, micro_busy=busy, micro_device_ms=dev_ms,
        micro_wall_ms=wall_us / 1e3, micro_launch_api_calls=api, flops=flops,
        mfu=mfu, losses=losses, grad_norms=gnorms)
    top = sorted(per_call.items(), key=lambda kv: -kv[1])[:6]
    log(f"  train_4k at accum {n} ({rows} x {S} micro-batches, bf16, remat "
        f"{cfg.remat}): steps {', '.join(f'{t:.1f}' for t in steps_ms)} ms "
        f"(warm-up, then two timed); {tok_s:.0f} tok/s; peak "
        f"{peak / 2**30:.3f} GiB (predicted {predicted / 2**30:.2f}); model "
        f"FLOPs {flops / 1e15:.3f} PFLOP/step, share of the bf16 dense peak "
        f"(989 TFLOP/s) {100 * mfu:.2f}%; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" (ln(vocab) {ln_v:.4f}); "
        f"grad_norms " + ", ".join(f"{x:.4f}" for x in gnorms)
        + f"; no kernel launched; one {rows} x {S} micro-batch profiled: host "
        f"wall {wall_us / 1e3:.1f} ms, device {dev_ms:.1f} ms, busy "
        f"{100 * busy:.1f}%, launch API calls {api:.0f}; top: "
        + "; ".join(f"{k[:48]} {t / 1e3:.1f} ms" for k, t in top))


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
    t0 = time.perf_counter()
    train_4k(cfg, params, m)
    m["train_4k"]["seconds"] = time.perf_counter() - t0
    return {k: counts[k] + c[k] for k in counts}, m


# ---------------------------------------------------------------------------
# the serving bench's twin on the card
# ---------------------------------------------------------------------------

BENCH_RUNS = 5


def bench_phase():
    """repro_torch.launch.serving_bench's run at its reference configuration
    (reduced dcache-agent-150m, head dim 16, the seeded weights of
    ``bench_serving``), its rows and its launch counts against the engine's
    own prefills and steps; phase 3's full-width dcache workload BENCH_RUNS
    times in this process after a warm-up (the spread of one card);
    bench_kernels' row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serving_bench
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = serving_bench.bench_config()
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ops.reset_launch_counts()
    eng, reqs, seconds = serving_bench.run_bench(cfg, params, 6, 8, "cuda")
    counts = ops.launch_counts()
    rows = serving_bench.serving_rows(eng, seconds)
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    log("  " + " | ".join(rows) + f"; prefills={eng.prefills} "
        f"decode_steps={eng.steps} launches={counts} expected={expected}")
    assert all(r.done for r in reqs), "unfinished bench requests"
    assert counts == expected, "bench launch counts differ"
    assert rows[1] == "serving,requests,6"

    cfg = get_config("dcache-agent-150m")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ServingEngine(cfg, params, max_batch=4, max_len=512,
                  device="cuda").generate_text(PROMPTS[0], max_new_tokens=4)
    runs = []
    for _ in range(BENCH_RUNS):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
        runs.append(serve_workload(eng))
    krow = serving_bench.bench_kernels()
    log("  " + krow[0])
    m = dict(rows=rows, kernel_row=krow[0], runs=runs, launches=counts)
    for key in ("tok_s", "mean_ttft_ms", "decode_step_ms"):
        vals = [r[key] for r in runs]
        m[key] = dict(median=statistics.median(vals), min=min(vals), max=max(vals))
    return counts, m


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
    prompt's bytes, the prompt bytes the engine kept (``submit`` keeps the
    last ``max_len // 2`` tokens), the wall ms with the card synchronized
    before and after, and the completion. Without an engine (a SimLLM
    decision plane) it records the prompt's bytes, ms and completion."""

    def __init__(self, llm, engine=None):
        self.llm, self.engine, self.calls = llm, engine, []

    def complete(self, prompt):
        eng = self.engine
        kept = eng.tok.encode(prompt)[-(eng.max_len // 2):] if eng else []
        sync = eng is not None and eng.device.type == "cuda"
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.llm.complete(prompt)
        if sync:
            torch.cuda.synchronize()
        self.calls.append(dict(
            prompt=prompt, prompt_bytes=len(prompt.encode()),
            kept_bytes=sum(i < 256 for i in kept),
            ms=1e3 * (time.perf_counter() - t0), completion=out))
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
    from repro_torch.kernels import ops
    from repro_torch.launch import tables
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("dcache-agent-150m")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ServingEngine(cfg, params, max_batch=4, max_len=512,
                  device="cuda").generate_text(PROMPTS[0], max_new_tokens=4)
    torch.cuda.synchronize()
    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    llm = DecisionLog(TorchLLM(eng, max_new_tokens=AGENT_NEW_TOKENS), eng)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    off = run_agent(llm, False, AGENT_TASKS)
    assert not llm.calls, "the run without the cache asked the model"
    on = run_agent(llm, True, AGENT_TASKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    calls = llm.calls
    _, rep_off, _, _ = off
    traces, rep_on, ctrl, cache = on
    st = cache.stats
    ms = [c["ms"] for c in calls]
    m = dict(decisions=len(calls), prefills=eng.prefills, steps=eng.steps,
             prompt_bytes=[c["prompt_bytes"] for c in calls],
             kept_bytes=[c["kept_bytes"] for c in calls],
             decision_ms=ms, decision_ms_median=statistics.median(ms),
             decision_ms_max=max(ms), parse_fallbacks=ctrl.parse_fallbacks,
             degraded=ctrl.degraded, graded=st.llm_total_decisions,
             graded_correct=st.llm_correct_decisions, hits=st.hits,
             misses=st.misses, evictions=st.evictions,
             avg_time_s_off=rep_off.avg_time_s, avg_time_s_on=rep_on.avg_time_s,
             sim_ratio=rep_off.avg_time_s / rep_on.avg_time_s,
             success_off=rep_off.success_rate, success_on=rep_on.success_rate,
             completions=[c["completion"] for c in calls][:4],
             launches=counts, wall_s=wall)
    log(f"  {len(calls)} decisions made by the model over {AGENT_TASKS} tasks "
        f"(prefills={eng.prefills} decode_steps={eng.steps}); prompt bytes "
        f"{m['prompt_bytes']}; kept by the engine {m['kept_bytes']}")
    log(f"  decision wall ms (synchronized): median {m['decision_ms_median']:.2f} "
        f"max {m['decision_ms_max']:.2f}; parse_fallbacks={ctrl.parse_fallbacks} "
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
    t1 = time.perf_counter()
    for name, (n, digest) in TABLE_DIGESTS.items():
        rows = getattr(tables, name)(n=n)
        got = hashlib.sha256(repr(rows).encode()).hexdigest()[:16]
        log(f"  {name}(n={n}) digest {got} (locked {digest}); {rows[-1]}")
        assert got == digest, f"{name} digest differs on the card's host"
    m["tables_s"] = time.perf_counter() - t1
    return counts, m


def agent_cpu_vs_card():
    """The reduced dcache-agent-150m (head dim 16, vocab 512) in fp32 as
    the decision model for 2 tasks, on the CPU and on the card from the
    same weights: the same completions and the same TaskTraces; the card
    run's launch counts against its engine's prefills and steps."""
    from repro_torch.agent import TorchLLM
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                              vocab_size=512, dtype="float32")
    gpu_params = init_model(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    out = {}
    for device, params in (("cpu", tree_to(gpu_params, "cpu")), ("cuda", gpu_params)):
        eng = ServingEngine(cfg, params, max_batch=4, max_len=128, device=device)
        llm = DecisionLog(TorchLLM(eng, max_new_tokens=8), eng)
        ops.reset_launch_counts()
        traces = run_agent(llm, True, 2)[0]
        out[device] = (llm.calls, traces, ops.launch_counts(),
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
    from repro_torch.kernels import ops
    from repro_torch.launch import tables
    from repro_torch.models.model import init_model
    from repro_torch.serving import ServingEngine

    cfg = get_config("dcache-agent-150m")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ServingEngine(cfg, params, max_batch=4, max_len=512,
                  device="cuda").generate_text(PROMPTS[0], max_new_tokens=4)
    torch.cuda.synchronize()
    eng = ServingEngine(cfg, params, max_batch=4, max_len=512, device="cuda")
    llm = DecisionLog(TorchLLM(eng, max_new_tokens=AGENT_NEW_TOKENS), eng)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    base = episode_summary(*run_concurrent(None, CONC_SESSIONS, CONC_TASKS))[0]
    t1 = time.perf_counter()
    ceng, cres, logs = run_concurrent(llm, CONC_SESSIONS, CONC_TASKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    served, calls = episode_summary(ceng, cres, logs)
    ms = [c["ms"] for c in calls]
    m = dict(served=served, simllm=base, simllm_wall_s=t1 - t0, served_wall_s=wall,
             prefills=eng.prefills, steps=eng.steps,
             prompt_bytes=[c["prompt_bytes"] for c in calls],
             kept_bytes=[c["kept_bytes"] for c in calls],
             decision_ms=ms, decision_ms_median=statistics.median(ms),
             decision_ms_max=max(ms),
             completions=[c["completion"] for c in calls][:4], launches=counts)
    log(f"  SimLLM planes: decisions {base['decisions']}; "
        + " ".join(f"{k}={base[k]}" for k in CONC_METRICS)
        + f"; parse_fallbacks {base['parse_fallbacks']} degraded {base['degraded']}")
    log(f"  served planes: {len(calls)} decisions made by the model "
        f"{served['decisions']} over {CONC_SESSIONS} sessions x {CONC_TASKS} "
        f"tasks (prefills={eng.prefills} decode_steps={eng.steps}); prompt bytes "
        f"{min(m['prompt_bytes'])}-{max(m['prompt_bytes'])}, kept by the engine "
        f"{min(m['kept_bytes'])}-{max(m['kept_bytes'])}")
    log(f"  served planes: decision wall ms (synchronized) median "
        f"{m['decision_ms_median']:.2f} max {m['decision_ms_max']:.2f}; "
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
    t2 = time.perf_counter()
    m["digests"] = {}
    for name, kw, digest in ENGINE_DIGESTS:
        kw = dict(kw)
        if kw.pop("mutations", False):
            kw["engine_kw"] = {"mutations": MutationPlan()}
        got = hashlib.sha256(repr(getattr(tables, name)(**kw)).encode()).hexdigest()[:16]
        log(f"  {name}({kw}) digest {got} (locked {digest})")
        assert got == digest, f"{name} digest differs on the card's host"
        m["digests"][name] = got
    m["tables_s"] = time.perf_counter() - t2
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
    from repro_torch.kernels import ops
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
            ops.reset_launch_counts()
            _, res, _ = run_concurrent(llm, n_sessions, n_tasks, n_pods=2,
                                       capacity_per_pod=2)
            runs[device] = (llm.calls, res.metrics.row(), ops.launch_counts(),
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


def train_flops(cfg, n_params, B, S):
    """Products of one training step: 6 N per token, plus the attention's
    QK^T and PV over the full S x S the eager route computes (4 B Hq S^2 hd
    a layer forward), run 4 times: forward, backward (2x) and the block
    remat's recompute."""
    attn = 4 * B * cfg.n_heads * S * S * cfg.head_dim_ * cfg.n_layers
    return 6 * n_params * B * S + 4 * attn


def train_full_width():
    """Full-width dcache-agent-150m in bf16 through the twin's own train()
    (TrainLoop over a Prefetcher of TokenStream(batch 8, seq 512, seed 0),
    AdamW lr 1e-3, 3 warmup steps, 30 steps): every loss and grad_norm
    finite, the mean of the last 5 losses at least 0.5 under the first 5's,
    no kernel launched. The trained params (bf16, no grad) then serve the
    twin's 8 prompts through its serve() with exact launch counts and one
    TorchLLM decision. Then 3 more steps under the profiler. Before it the
    same 30 steps with remat="dots" from the same seeds: its median step
    and peak memory beside block's, every loss within 1e-3 relative."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import HeartbeatMonitor
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_llm
    from repro_torch.models.model import init_model
    from repro_torch.training import AdamWConfig, Prefetcher, TokenStream

    def run(remat):
        """TRAIN_STEPS steps of the twin's train() under ``remat``, from the
        same weights and data seeds."""
        cfg = dataclasses.replace(get_config("dcache-agent-150m"), remat=remat)
        params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mon = HeartbeatMonitor()
        pf = Prefetcher(TokenStream(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=0))
        t0 = time.perf_counter()
        try:
            loop, metrics = serve_llm.train(
                cfg, params, pf, TRAIN_STEPS,
                AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=TRAIN_STEPS),
                monitor=mon)
        finally:
            pf.close()
        return (cfg, loop, metrics, mon, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    before = ops.launch_counts()
    # remat="dots" (the products' outputs kept) beside the default "block"
    dcfg, dloop, dmetrics, dmon, _, dpeak = run("dots")
    assert ops.launch_counts() == before, "training launched a hand-written kernel"
    del dloop
    free_card()
    cfg, loop, metrics, mon, wall, peak = run("block")
    assert cfg.remat == "block" and dcfg.remat == "dots"
    n_params = sum(t.numel() for t in tree_leaves(loop.params))
    dots = dict(losses=[m["loss"] for m in dmetrics],
                step_ms=1e3 * statistics.median(dmon.step_times), peak_bytes=dpeak)
    losses = [m["loss"] for m in metrics]
    dots["max_loss_rel"] = max(abs(a - b) / abs(b)
                               for a, b in zip(dots["losses"], losses))
    log(f"  remat dots vs block, {TRAIN_STEPS} steps at {TRAIN_B}x{TRAIN_S}: "
        f"median step {dots['step_ms']:.2f} vs "
        f"{1e3 * statistics.median(mon.step_times):.2f} ms, peak memory "
        f"{dpeak / 2**30:.3f} vs {peak / 2**30:.3f} GiB; largest loss "
        f"difference {dots['max_loss_rel']:.2e} relative (<= 1e-3)")
    assert dots["max_loss_rel"] <= 1e-3, "dots and block losses differ"
    gnorms = [m["grad_norm"] for m in metrics]
    assert all(map(math.isfinite, losses + gnorms)), "a loss or grad_norm is not finite"
    first, last = statistics.fmean(losses[:5]), statistics.fmean(losses[-5:])
    assert last <= first - 0.5, f"loss fell from {first:.3f} to {last:.3f} only"
    assert ops.launch_counts() == before, "training launched a hand-written kernel"
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad
               for t in tree_leaves(loop.params)), "trained params are not plain bf16"
    step_ms = 1e3 * statistics.median(mon.step_times)
    tok_s = TRAIN_B * TRAIN_S / (step_ms / 1e3)
    log(f"  trained {TRAIN_STEPS} steps at {TRAIN_B}x{TRAIN_S} in {wall:.2f} s: "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (mean of first 5 {first:.3f}, "
        f"last 5 {last:.3f}); grad_norm {gnorms[0]:.3f} -> {gnorms[-1]:.3f}; "
        f"median step {step_ms:.2f} ms = {tok_s:.0f} tok/s; peak memory "
        f"{peak / 2**30:.3f} GiB; kernel launches in training: 0")

    ops.reset_launch_counts()
    eng, reqs = serve_llm.serve(cfg, loop.params, serve_llm.PROMPTS, device="cuda")
    text = serve_llm.decide(eng)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expected = expected_launches(cfg, eng.prefills, eng.steps)
    assert all(r.done for r in reqs) and len(reqs) == 8, "unfinished requests"
    assert isinstance(text, str), "TorchLLM returned no text"
    log(f"  served the trained params: prefills={eng.prefills} "
        f"decode_steps={eng.steps} launches={counts} expected={expected}; "
        f"TorchLLM -> {text!r}")
    assert counts == expected, "launch counts differ from the main path's"

    # 3 more steps under the profiler (after serving: the served weights
    # are the 30-step ones)
    batch = batch_to(TokenStream(cfg, batch=TRAIN_B, seq=TRAIN_S,
                                 seed=1).next_batch(), "cuda")
    state = {"p": loop.params, "o": loop.opt_state}

    def one_step():
        state["p"], state["o"], _ = loop.step_fn(state["p"], state["o"], batch)

    per_call, busy, wall_us, api = device_profile(one_step, 3,
                                                  "profile_dcache_train_step.txt")
    dev_us = sum(per_call.values())
    flops = train_flops(cfg, n_params, TRAIN_B, TRAIN_S)
    mfu = flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16]
    top = sorted(per_call.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile train step: host wall {wall_us / 1e3:.2f} ms/step, device "
        f"{dev_us / 1e3:.2f} ms/step, device busy {100 * busy:.1f}%, launch API "
        f"calls/step {api:.0f}; model FLOPs {flops / 1e12:.3f} TFLOP/step, "
        f"share of the bf16 dense peak (989 TFLOP/s, H100 SXM5) "
        f"{100 * mfu:.2f}%; top: "
        + "; ".join(f"{k[:48]} {t / 1e3:.2f} ms" for k, t in top))
    return counts, dict(
        steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, params=n_params,
        losses=losses, grad_norms=gnorms, first5=first, last5=last,
        step_ms=step_ms, step_ms_all=[1e3 * t for t in mon.step_times],
        tok_s=tok_s, peak_bytes=peak, wall_s=wall, profile_wall_ms=wall_us / 1e3,
        profile_device_ms=dev_us / 1e3, busy=busy, launch_api_calls=api,
        flops=flops, mfu=mfu, peak_flops=PEAK_FLOPS[torch.bfloat16],
        top_us=dict(top), serve_launches=counts, decision=text, dots=dots)


def smoke_launchers():
    """launch.serve's ``--smoke`` main (reduced dcache-agent-150m, and
    ``--arch rwkv6-7b``: WKV and rmsnorm at head dim 16) and
    launch.serve_llm's on the card, each held to the launch counts its
    returned engine's prefills and steps imply (serve_llm's training
    launches none)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, serve_llm

    counts, m = {}, {}
    for name, argv, fn in (("launch.serve", ["--smoke"], serve.main),
                           ("launch.serve rwkv6-7b", ["--smoke", "--arch", "rwkv6-7b"],
                            serve.main),
                           ("launch.serve_llm", ["--smoke"], serve_llm.main)):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng = fn(argv)
        torch.cuda.synchronize()
        c = ops.launch_counts()
        expected = expected_launches(eng.cfg, eng.prefills, eng.steps)
        m[name] = dict(seconds=time.perf_counter() - t0, prefills=eng.prefills,
                       steps=eng.steps, launches=c)
        log(f"  {name} --smoke on cuda: {m[name]['seconds']:.2f} s, "
            f"prefills={eng.prefills} decode_steps={eng.steps} launches={c} "
            f"expected={expected}")
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
        t0 = time.perf_counter()
        _, _, m = step(p, init_opt_state(p), b)
        grads, _ = loss_and_grads(cfg, p, b)
        out[dev] = (m, tree_leaves(grads), time.perf_counter() - t0)
    (mc, gc_, tc), (mg, gg, tg) = out["cpu"], out["cuda"]
    loss_rel = abs(float(mc["loss"]) - float(mg["loss"])) / abs(float(mc["loss"]))
    gn_rel = abs(float(mc["grad_norm"]) - float(mg["grad_norm"])) / float(mc["grad_norm"])
    leaf_rel = max((a - b.cpu()).abs().max().item() / max(a.abs().max().item(), 1e-30)
                   for a, b in zip(gc_, gg))
    log(f"  {arch} train step cpu vs card fp32 (2 layers, full width, B={B} "
        f"S={S}): loss {float(mc['loss']):.6f} vs {float(mg['loss']):.6f} "
        f"(rel {loss_rel:.2e} <= 1e-4), grad_norm {float(mc['grad_norm']):.6f} "
        f"vs {float(mg['grad_norm']):.6f} (rel {gn_rel:.2e} <= 1e-3), largest "
        f"per-leaf gradient error / leaf max {leaf_rel:.2e}; cpu {tc:.2f} s, "
        f"card {tg:.2f} s")
    assert loss_rel <= 1e-4, f"{arch}: loss differs by {loss_rel:.2e} relative"
    assert gn_rel <= 1e-3, f"{arch}: grad_norm differs by {gn_rel:.2e} relative"
    return dict(loss_rel=loss_rel, grad_norm_rel=gn_rel, leaf_rel=leaf_rel,
                cpu_s=tc, card_s=tg)


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

    from repro_torch.distributed import checkpoint as ckpt_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_llm, train, train_tiny

    ckdir = os.path.join(ROOT, "build", "ckpt_phase6")
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = ["--arch", "dcache-agent-150m", "--preset", "full",
            "--steps", str(CKPT_STEPS), "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_S), "--lr", "1e-3", "--ckpt-dir", ckdir,
            "--ckpt-every", "0"]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    loop = train.main(argv)
    train_s = time.perf_counter() - t0
    assert ops.launch_counts() == before, "training launched a hand-written kernel"
    assert all(map(math.isfinite, loop.history)), "a loss is not finite"
    ck = loop.ckpt
    assert ck.available_steps() == [CKPT_STEPS], "not exactly one checkpoint"
    step_dir = ck._step_dir(CKPT_STEPS)
    disk = sum(os.path.getsize(os.path.join(step_dir, f))
               for f in os.listdir(step_dir))
    sv = dict(ck.last_save)
    # the save's first part, the JAX-layout stack on the card, runs before
    # the checkpointer's clock starts: time it again on the saved state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop._ckpt_tree()
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    save_s = layout_s + sv["snapshot_s"] + sv["write_s"]
    m = dict(codec=ck.codec, zstandard_present=ckpt_mod.zstandard is not None,
             steps=CKPT_STEPS, train_s=train_s, losses=loop.history,
             bytes_on_disk=disk, shard_bytes=sv["bytes"],
             raw_bytes=sv["raw_bytes"], layout_s=layout_s,
             snapshot_s=sv["snapshot_s"], write_s=sv["write_s"],
             save_s=save_s, save_mb_s=sv["raw_bytes"] / 1e6 / save_s)
    log(f"  trained {CKPT_STEPS} steps at {TRAIN_B}x{TRAIN_S} through "
        f"launch.train in {train_s:.2f} s (loss {loop.history[0]:.3f} -> "
        f"{loop.history[-1]:.3f}); one save at step {CKPT_STEPS}, codec "
        f"{ck.codec} (zstandard {'present' if m['zstandard_present'] else 'absent'})"
        f": {disk} bytes on disk ({sv['raw_bytes']} bytes of msgpack, ratio "
        f"{sv['bytes'] / sv['raw_bytes']:.3f}); JAX-layout stack on the card "
        f"{layout_s:.3f} s (timed again on the saved state), copy to the "
        f"host {sv['snapshot_s']:.3f} s, write {sv['write_s']:.2f} s (pack, "
        f"compress, digest, rename); save {save_s:.2f} s = "
        f"{m['save_mb_s']:.1f} MB/s of msgpack")

    restored = {}
    for dev in ("cuda", "cpu"):
        # the whole cold restart: init, then restore_if_available (both
        # digest passes, inflate, unpack, copy to the device)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop2, data = train.build(train.parse_args(
            argv + ["--resume", "--device", dev]))
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        data.close()
        r = dict(loop2.ckpt.last_restore)
        same_loop_state(loop2, loop, f"cold restart on {dev}")
        assert loop2.params["embed"].device.type == dev
        restored[dev] = loop2
        # Checkpointer.restore's own clock: its digest pass, inflate, unpack
        m[f"restore_{dev}"] = dict(r, host_read_s=r["seconds"], seconds=wall,
                                   mb_s=r["raw_bytes"] / 1e6 / wall)
        log(f"  cold restart with --resume on {dev}: {wall:.2f} s = "
            f"{m[f'restore_{dev}']['mb_s']:.1f} MB/s of msgpack (init, both "
            f"digest passes, inflate, unpack, copy to {dev}); of it "
            f"Checkpointer.restore's host read {r['seconds']:.2f} s (its "
            f"digest pass {r['valid_s']:.2f} s); params (bf16), mu/nu (fp32) "
            f"and step {loop2.step_idx} equal to the saved ones bit for bit")
    del restored["cpu"]
    shutil.rmtree(ckdir, ignore_errors=True)

    cfg = loop.cfg
    ops.reset_launch_counts()
    eng, reqs = serve_llm.serve(cfg, restored["cuda"].params, serve_llm.PROMPTS,
                                device="cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
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

    t0 = time.perf_counter()
    tiny = train_tiny.main(["--steps", str(TINY_STEPS)])
    tiny_s = time.perf_counter() - t0
    fails = tiny["failures"]
    assert [f["restored"] for f in fails] == [True, True], \
        f"failures not recovered from disk: {fails}"
    assert tiny["restarted"].step_idx == TINY_STEPS, "cold restart is short"
    assert tiny["loop"].params["embed"].is_cuda
    m["train_tiny"] = dict(steps=TINY_STEPS, fail_at=tiny["fail_at"],
                           failures=fails, kept=tiny["kept"], seconds=tiny_s,
                           losses=tiny["loop"].history)
    log(f"  train_tiny on the card ({tiny['loop'].cfg.name}, {TINY_STEPS} "
        f"steps): failures at {tiny['fail_at']} recovered from disk, kept "
        f"{tiny['kept']}, cold restart at step {TINY_STEPS}; {tiny_s:.2f} s")
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

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.load_library()
    log(f"  built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_log.get('seconds', 0.0):.2f} s)")
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

    log("phase 2: kernels against their plain versions on the card")
    t2 = time.perf_counter()
    errs = {}
    check_kernels(errs)
    timing = time_kernels()
    phase_s = {"2": time.perf_counter() - t2}

    counts, serve = {}, {}
    for arch, kvq, layers in SERVED_PATHS:
        name = arch + ("+kv_quant" if kvq else "")
        log(f"phase 3: full-width serving, {name}")
        t3 = time.perf_counter()
        if get_config(arch).is_encdec:
            c, serve[name] = serve_encdec(arch)
        else:
            c, serve[name] = serve_full_width(arch, kv_quant=kvq, n_layers=layers)
        serve[name]["phase_s"] = time.perf_counter() - t3
        log(f"  {name}: phase 3 took {serve[name]['phase_s']:.1f} s")
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        free_card()

    log("paged phase: the paged KV cache at full width")
    c, paged = paged_phase()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    errs["decode_attention"] = max(errs["decode_attention"], paged["max_abs_err"])
    free_card()

    log("assigned shapes: decode_32k, prefill_32k and train_4k, full-width "
        "dcache-agent-150m in bf16")
    ta = time.perf_counter()
    c, shapes = assigned_shapes()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    for k, v in shapes.pop("errs").items():
        errs[k] = max(errs[k], v)
    phase_s["assigned shapes"] = time.perf_counter() - ta
    phase_s["train_4k"] = shapes["train_4k"]["seconds"]
    free_card()

    log("bench: the serving bench's twin on the card")
    tb = time.perf_counter()
    c, bench = bench_phase()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    phase_s["bench"] = time.perf_counter() - tb
    free_card()

    log("agent: the paper's cache decisions made by full-width "
        "dcache-agent-150m on the card")
    tg = time.perf_counter()
    c, agent = agent_phase()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    phase_s["agent"] = time.perf_counter() - tg
    free_card()

    log("concurrent: the fleet's admission and replication decisions made by "
        "full-width dcache-agent-150m on the card")
    tc = time.perf_counter()
    c, conc = concurrent_phase()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    phase_s["concurrent"] = time.perf_counter() - tc
    free_card()

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
        t4 = time.perf_counter()
        worst, ties, flips = cpu_vs_card(arch, kv_quant=kvq)
        phase_s["4 " + name] = time.perf_counter() - t4
        serve[name].update(cpu_vs_card_max_logit_diff=worst,
                           cpu_vs_card_near_ties=ties,
                           cpu_vs_card_int8_code_flips=flips)
        free_card()
    # the reduced configs (head dim 16) of every family: the dense ones (the
    # four variants too), rwkv6 (WKV at head dim 16), MoE (llama4 too: its
    # reduced super-layer fits where full width does not), hybrid, encdec
    # and vlm; then the launchers' --smoke mains on the card
    reduced = {}
    for arch in REDUCED_ARCHS:
        log(f"phase 4: CPU vs card, fp32, {arch} reduced")
        t4 = time.perf_counter()
        worst, ties, _ = cpu_vs_card(arch, reduced=True)
        phase_s["4 " + arch + " reduced"] = time.perf_counter() - t4
        reduced[arch] = dict(max_logit_diff=worst, near_ties=ties)
        free_card()
    log("phase 4: CPU vs card, fp32, the reduced dcache as the cache "
        "controller's decision model")
    t4 = time.perf_counter()
    agent["cpu_vs_card"] = agent_cpu_vs_card()
    phase_s["4 agent"] = time.perf_counter() - t4
    free_card()
    log("phase 4: CPU vs card, fp32, the reduced dcache as the concurrent "
        "engine's admission and replication decision model")
    t4 = time.perf_counter()
    conc["cpu_vs_card"] = concurrent_cpu_vs_card()
    phase_s["4 concurrent"] = time.perf_counter() - t4
    free_card()
    log("phase 4: the launchers' --smoke mains on the card")
    t4 = time.perf_counter()
    c, smoke = smoke_launchers()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    phase_s["4 smoke launchers"] = time.perf_counter() - t4
    free_card()

    log("phase 5: training on the card, then serving the trained weights")
    t5 = time.perf_counter()
    free_card()
    c, training = train_full_width()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    free_card()
    for arch, B, S in (("dcache-agent-150m", 2, 64), ("rwkv6-7b", 1, 32)):
        training[f"cpu_vs_card_{arch}"] = train_cpu_vs_card(arch, B, S)
        free_card()
    training["phase_s"] = time.perf_counter() - t5

    log("phase 6: checkpoints, cold restarts, serving the restored weights")
    t6 = time.perf_counter()
    c, ckpt = checkpoint_phase()
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    free_card()
    ckpt["phase_s"] = time.perf_counter() - t6

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card} | training dcache-agent-150m {TRAIN_B}x{TRAIN_S} bf16: "
        f"step_ms={training['step_ms']:.2f} tok_s={training['tok_s']:.0f} "
        f"peak_GiB={training['peak_bytes'] / 2**30:.3f} "
        f"busy={100 * training['busy']:.1f}% "
        f"launch_api_calls={training['launch_api_calls']:.0f} "
        f"model_flop_share={100 * training['mfu']:.2f}% of 989 TFLOP/s")
    d = training["dots"]
    log(f"card: {card} | training remat dots vs block: step_ms="
        f"{d['step_ms']:.2f} vs {training['step_ms']:.2f} peak_GiB="
        f"{d['peak_bytes'] / 2**30:.3f} vs {training['peak_bytes'] / 2**30:.3f} "
        f"max_loss_rel={d['max_loss_rel']:.2e}")
    dk, pf = shapes["decode_32k"], shapes["prefill_32k"]
    log(f"card: {card} | decode_32k dcache-agent-150m B={dk['B']} C={dk['C']}: "
        f"step_ms={dk['step_ms']:.3f} device_ms={dk['device_ms']:.3f} "
        f"decode_kernel_us={dk['decode_kernel_us']:.1f} "
        f"bound_ms={dk['bound_ms']:.3f} share_of_bound="
        f"{100 * dk['share_of_bound']:.1f}%")
    log(f"card: {card} | prefill_32k dcache-agent-150m B={pf['B']} S={pf['S']}"
        f"{' (batch cut)' if pf['batch_cut'] else ''}: prefill_ms="
        f"{pf['prefill_ms']:.1f} device_ms={pf['device_ms']:.1f} flash_share="
        f"{100 * pf['flash_share']:.1f}% bound_ms={pf['bound_ms']:.2f} "
        f"flash_layer_ms={pf['flash_layer_ms']:.2f} sdpa_layer_ms="
        f"{pf['sdpa_layer_ms']:.2f} peak_GiB={pf['peak_bytes'] / 2**30:.2f}")
    t4k = shapes["train_4k"]
    log(f"card: {card} | train_4k dcache-agent-150m B={t4k['B']} S={t4k['S']} "
        f"bf16 accum={t4k['accum']} ({t4k['micro_batch']} x {t4k['S']}): "
        f"step_ms={t4k['step_ms']:.1f} tok_s={t4k['tok_s']:.0f} "
        f"peak_GiB={t4k['peak_bytes'] / 2**30:.3f} "
        f"model_flop_share={100 * t4k['mfu']:.2f}% of 989 TFLOP/s "
        f"micro_batch_busy={100 * t4k['micro_busy']:.1f}%; accum "
        f"{t4k['first_accum']}: micro_batch_peak_GiB="
        f"{t4k['first_micro_peak_bytes'] / 2**30:.3f}")
    log(f"card: {card} | agent dcache-agent-150m bf16, {AGENT_TASKS} tasks: "
        f"decisions={agent['decisions']} decision_ms median="
        f"{agent['decision_ms_median']:.2f} max={agent['decision_ms_max']:.2f} "
        f"kept_bytes max={max(agent['kept_bytes'])} of prompt_bytes max="
        f"{max(agent['prompt_bytes'])} parse_fallbacks={agent['parse_fallbacks']} "
        f"degraded={agent['degraded']} hits={agent['hits']} "
        f"sim avg_time_s off={agent['avg_time_s_off']:.4f} "
        f"on={agent['avg_time_s_on']:.4f} ratio={agent['sim_ratio']:.4f} "
        f"launches={agent['launches']}")
    sv, sb = conc["served"], conc["simllm"]
    log(f"card: {card} | concurrent {CONC_SESSIONS} sessions x {CONC_TASKS} "
        f"tasks, dcache-agent-150m bf16 behind admission and replication: "
        f"decisions={sv['decisions']} (SimLLM {sb['decisions']}) decision_ms "
        f"median={conc['decision_ms_median']:.2f} max={conc['decision_ms_max']:.2f} "
        f"kept_bytes max={max(conc['kept_bytes'])} of prompt_bytes max="
        f"{max(conc['prompt_bytes'])} parse_fallbacks={sv['parse_fallbacks']} "
        f"sim p95_s served={sv['p95_task_latency_s']:.4f} "
        f"SimLLM={sb['p95_task_latency_s']:.4f} local_hit_rate served="
        f"{sv['local_hit_rate']:.4f} SimLLM={sb['local_hit_rate']:.4f} "
        f"launches={conc['launches']}")
    log(f"card: {card} | bench {' '.join(bench['rows'][1:])} "
        f"{bench['kernel_row']}")
    log(f"card: {card} | dcache-agent-150m serving x{BENCH_RUNS} in one process "
        + " ".join(f"{k}=median {v['median']:.3f} min {v['min']:.3f} max "
                   f"{v['max']:.3f}" for k, v in bench.items()
                   if k in ("tok_s", "mean_ttft_ms", "decode_step_ms")))
    rc, rg = ckpt["restore_cpu"], ckpt["restore_cuda"]
    log(f"card: {card} | checkpoint dcache-agent-150m ({ckpt['codec']}): "
        f"bytes_on_disk={ckpt['bytes_on_disk']} save_s={ckpt['save_s']:.2f} "
        f"save_MB_s={ckpt['save_mb_s']:.1f} cold_restart_s cuda={rg['seconds']:.2f} "
        f"cpu={rc['seconds']:.2f} cold_restart_MB_s cuda={rg['mb_s']:.1f} "
        f"cpu={rc['mb_s']:.1f} host_read_s cuda={rg['host_read_s']:.2f} "
        f"cpu={rc['host_read_s']:.2f} phase_s={ckpt['phase_s']:.1f}")
    for name, sv in serve.items():
        log(f"card: {card} | {name} serving L={sv['n_layers']}/{sv['full_layers']} "
            f"tok/s={sv['tok_s']:.1f} mean_ttft_ms={sv['mean_ttft_ms']:.2f} "
            f"decode_step_ms={sv['decode_step_ms']:.3f} "
            f"decode_device_ms={sv['decode_device_ms']:.3f} "
            f"prefill_device_ms={sv['prefill_device_ms']:.3f} "
            f"kv_MiB={sv.get('kv_cache_bytes', 0) / 2**20:.1f} "
            f"decode_launch_api_calls={sv['decode_launch_api_calls']:.1f} "
            f"decode_busy={100 * sv['decode_busy']:.1f}% "
            f"weights_read_floor_ms={sv['weights_read_floor_ms']:.3f}")
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
                   "src/repro/kernels/rwkv_wkv.py:56")}
    # launches: summed over phase 3's served paths, the paged phase, the
    # assigned shapes (decode_32k, prefill_32k), the bench's served run, the
    # agent and concurrent phases' decisions, the two --smoke mains and the serving of the trained and of the restored
    # weights; each counted from zero and held to the counts its own
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
