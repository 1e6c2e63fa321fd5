"""Architecture registry: ``get_config("<arch-id>")``.

Every family of the reference is registered: dense, ssm (rwkv6), moe,
hybrid, encdec (seamless-m4t-large-v2) and vlm (llava-next-34b). The port
also registers deepseek-v2-lite (latent attention), which the reference
lacks: ``get_config`` finds it, and ``ARCH_IDS``/``ALL_IDS`` keep to the
reference's registry.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: F401
                                      SSMConfig, YarnScaling)
from repro_torch.configs.shapes import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ShapeSpec,
    alloc_cache,
    effective_cache_len,
    input_axes,
    input_specs,
    shape_applicable,
)

# arch-id (CLI form, dashed) -> module name, in the reference's order
_ARCH_MODULES: Dict[str, str] = {
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-3-2b": "granite_3_2b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen3-4b": "qwen3_4b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-34b": "llava_next_34b",
    "hymba-1.5b": "hymba_1_5b",
    # the paper's own workload (agent decision model)
    "dcache-agent-150m": "dcache_agent_150m",
}

# the assigned architectures: all but the paper's own decision model
ARCH_IDS: List[str] = [a for a in _ARCH_MODULES if a != "dcache-agent-150m"]
ALL_IDS: List[str] = list(_ARCH_MODULES)

# the port's own: served by get_config, not in the reference's lists
_ARCH_MODULES["deepseek-v2-lite"] = "deepseek_v2_lite"


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG
