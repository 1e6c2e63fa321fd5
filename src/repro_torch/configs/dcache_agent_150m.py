"""dcache-agent-150m — the paper's own workload: a small tool-calling agent
LM served by ``repro_torch.serving`` and used as the ``TorchLLM`` decision
model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dcache-agent-150m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=32768,
    tie_embeddings=True,
)
