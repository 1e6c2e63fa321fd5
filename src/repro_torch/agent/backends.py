"""Decision-model backend for the agent (``repro.agent.backends.JaxLLM``)."""
from __future__ import annotations


class TorchLLM:
    """Real decision model: completions generated by the port's serving
    engine (``repro_torch.serving.ServingEngine``)."""

    def __init__(self, engine, max_new_tokens: int = 64):
        self.engine = engine
        self.max_new_tokens = max_new_tokens

    def complete(self, prompt: str) -> str:
        return self.engine.generate_text(prompt, self.max_new_tokens)
