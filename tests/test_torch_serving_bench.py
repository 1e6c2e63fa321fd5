"""The serving-bench twin (``repro_torch.launch.serving_bench``) against
``benchmarks/serving_bench.py``: the same rows under the same names, the
same served tokens from the same weights, and ``bench_kernels`` refused
without a card.

The reference's bench weights (``init_model(Init(PRNGKey(0)))`` of the
reduced dcache-agent-150m at vocab 512, bf16) come across by
``params_from_numpy``; both engines serve the bench's six requests of 8
new tokens at ``max_batch`` 4, ``max_len`` 128.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serving_bench


def names(rows):
    return [",".join(r.split(",")[:2]) for r in rows]


def test_rows_and_names_equal_reference():
    from benchmarks import serving_bench as ref

    want = ref.bench_serving()
    got = serving_bench.bench_serving(device="cpu")
    assert names(got) == names(want)
    assert got[0] == want[0] == "bench,metric,value"
    for row in got[1:]:
        float(row.split(",")[2])
    assert got[1] == want[1] == "serving,requests,6"


def test_bench_config_is_the_reference_one():
    cfg = serving_bench.bench_config()
    ref = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                              vocab_size=512)
    assert cfg.vocab_size == 512 and cfg.head_dim_ == ref.head_dim_ == 16
    for f in dataclasses.fields(ref):
        if f.name not in ("moe", "ssm"):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name


def test_bench_engine_serves_jax_bench_tokens():
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               vocab_size=512)
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jcfg.jnp_dtype), jcfg))
    jeng = JaxServingEngine(jcfg, jp, max_batch=4, max_len=128)
    jreqs = [jeng.submit(f"benchmark request number {i}", max_new_tokens=8)
             for i in range(6)]
    jeng.run_until_done()
    cfg = serving_bench.bench_config()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    eng, reqs, dt = serving_bench.run_bench(cfg, tp, 6, 8, "cpu")
    assert dt > 0 and eng.stats()["finished"] == 6
    assert [r.out_ids for r in reqs] == [r.out_ids for r in jreqs]
    assert eng.steps == jeng.steps


def test_bench_kernels_needs_the_card():
    with pytest.raises(RuntimeError, match="card only"):
        serving_bench.bench_kernels(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving_bench.bench_kernels()
