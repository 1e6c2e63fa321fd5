"""Agent side of the port: the tool-calling agent over the GeoLLM-Engine
simulator (copies of the reference's ``repro.agent`` modules for the
Tables I-III path) and the ``TorchLLM`` decision backend."""
from repro_torch.agent.agent import AgentRunner, TaskTrace  # noqa: F401
from repro_torch.agent.backends import PROFILES, Profile, SimLLM, TorchLLM  # noqa: F401
from repro_torch.agent.runtime import Runtime, build_runtime, build_tasks  # noqa: F401
