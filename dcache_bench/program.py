"""The system under test: ``repro_torch``'s serving engine, and nothing else.

This is the only module of the benchmark that imports the program. It
turns a configuration file's sizes into the port's ``ModelConfig`` and
builds the ``ServingEngine`` that the window drives through ``submit`` and
``step``, the path by which ``TorchLLM`` serves every decision the agent
makes.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import _build
from repro_torch.models import mlp_moe
from repro_torch.serving.engine import ServingEngine


def model_config(name: str, sizes: Dict) -> ModelConfig:
    moe = (MoEConfig(n_experts=sizes["n_experts"], top_k=sizes["top_k"],
                     interleave=1) if sizes.get("n_experts") else None)
    return ModelConfig(
        name=name, family=sizes["family"], n_layers=sizes["n_layers"],
        d_model=sizes["d_model"], n_heads=sizes["n_heads"],
        n_kv_heads=sizes["n_kv_heads"], d_ff=sizes["d_ff"],
        vocab_size=sizes["vocab_size"], head_dim=sizes["head_dim"],
        rope_theta=sizes["rope_theta"], sliding_window=sizes.get("sliding_window"),
        moe=moe, norm_eps=sizes["norm_eps"],
        tie_embeddings=sizes["tie_embeddings"], dtype=sizes["dtype"])


def load_kernels() -> Optional[float]:
    """Build the kernel library into the checkout's ``build/kernels/`` (the
    first run of a checkout) or load it; nvcc's seconds where it built."""
    _build.build_log.pop("seconds", None)
    _build.load_library()
    return _build.build_log.get("seconds")


def engine(name: str, sizes: Dict, params: Dict, device) -> ServingEngine:
    return ServingEngine(model_config(name, sizes), params,
                         max_batch=sizes["max_batch"], max_len=sizes["max_len"],
                         device=device)


# the module whose ``moe`` the model calls for every expert layer; a traced
# run wraps that attribute in a host range (trace.py)
MOE_MODULE = mlp_moe
