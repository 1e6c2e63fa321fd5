"""Agent-side pieces of the port: the ``TorchLLM`` decision backend."""
from repro_torch.agent.backends import TorchLLM  # noqa: F401
