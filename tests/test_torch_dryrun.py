"""The port's dry-run terms (``repro_torch.launch.dryrun``) against the JAX
package's, for every architecture, assigned shape, chip count and KV cache
type: ``analytic_hbm_bytes``, ``ssm_recurrence_flops`` (the reference's
``_ssm_recurrence_flops``) and ``model_flops`` (the rule inline in the
reference's ``dryrun_cell``), to relative 1e-12.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported, so it is
imported inside the tests (tests/test_dryrun_smoke.py imports it at
collection already); nothing here depends on the JAX device count.
"""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.launch import dryrun as tdry


def jax_model_flops(cfg, shape):
    """``repro.launch.dryrun.dryrun_cell``'s model-FLOP rule."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6 * n_active * B * S
    if shape.kind == "prefill":
        return 2 * n_active * B * S
    return 2 * n_active * B


@pytest.mark.parametrize("n_chips", [1, 256, 512])
@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ALL_IDS)
def test_analytic_terms_equal_jax(arch, shape, n_chips):
    from repro.launch import dryrun as jdry

    for kv_quant in (False, True):
        jcfg = dataclasses.replace(jconfigs.get_config(arch), kv_quant=kv_quant)
        tcfg = dataclasses.replace(tconfigs.get_config(arch), kv_quant=kv_quant)
        js, ts = jconfigs.SHAPES[shape], tconfigs.SHAPES[shape]
        want = jdry.analytic_hbm_bytes(jcfg, js, n_chips)
        assert want > 0
        assert tdry.analytic_hbm_bytes(tcfg, ts, n_chips) == pytest.approx(
            want, rel=1e-12)
        assert tdry.ssm_recurrence_flops(tcfg, ts) == pytest.approx(
            jdry._ssm_recurrence_flops(jcfg, js), rel=1e-12)
        assert tdry.model_flops(tcfg, ts) == pytest.approx(
            float(jax_model_flops(jcfg, js)), rel=1e-12)


def test_kv_quant_halves_decode_cache_traffic():
    cfg = tconfigs.get_config("dcache-agent-150m")
    s = tconfigs.DECODE_32K
    base = tdry.analytic_hbm_bytes(cfg, s, 1)
    q = tdry.analytic_hbm_bytes(dataclasses.replace(cfg, kv_quant=True), s, 1)
    L, B, C = cfg.n_layers, s.global_batch, s.seq_len
    kv = L * B * C * cfg.n_kv_heads * cfg.head_dim_ * 2 * 2.0
    scales = L * B * C * cfg.n_kv_heads * 2 * 2.0
    assert base - q == pytest.approx(kv / 2 - scales, rel=1e-12)


def test_cell_reports_skips_and_terms():
    c = tdry.cell("dcache-agent-150m", "long_500k", 1)
    assert c["skipped"].startswith("pure full-attention arch")
    c = tdry.cell("dcache-agent-150m", "decode_32k", 1)
    assert c["hbm_bytes"] == tdry.analytic_hbm_bytes(
        tconfigs.get_config("dcache-agent-150m"), tconfigs.DECODE_32K, 1)
    assert c["model_flops_per_chip"] == c["model_flops_total"]
