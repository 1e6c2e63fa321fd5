"""Agent side of the port: the tool-calling agent over the GeoLLM-Engine
simulator, the concurrent multi-session engine (copies of the reference's
``repro.agent`` modules) and the ``TorchLLM`` decision backend."""
from repro_torch.agent.agent import AgentRunner, TaskTrace  # noqa: F401
from repro_torch.agent.backends import PROFILES, Profile, SimLLM, TorchLLM  # noqa: F401
from repro_torch.agent.concurrency import (  # noqa: F401
    ConcurrentEpisodeEngine,
    EpisodeMetrics,
    EpisodeResult,
    run_episode,
    session_seed,
)
from repro_torch.agent.runtime import Runtime, build_runtime, build_tasks  # noqa: F401
