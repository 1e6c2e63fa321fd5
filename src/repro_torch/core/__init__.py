"""LLM-dCache core, the port's copy of the reference's ``repro.core``.

Cache mechanism (``cache``), eviction policies with natural-language
descriptions (``policies``), cross-session admission with a shared
frequency sketch (``admission``), cache ops as callable tools (``tools``),
programmatic vs GPT-driven controllers (``controller``), prompt templates
(``prompts``), endpoint pools (``endpoints``), fault schedules (``faults``),
the plan cache (``plan_cache``), multi-pod localized caching
(``distributed_cache``, ``locality``, ``replication``), the mutable data
plane (``coherence``), open-loop session-arrival processes (``traffic``)
and the mechanism counters (``profiling``). Framework-free numpy and Python,
copied line for line so that every table stays bit-identical.
"""
from repro_torch.core.admission import (  # noqa: F401
    ADMISSIONS,
    AdmissionPolicy,
    AdmitAll,
    Doorkeeper,
    FrequencySketch,
    LLMAdmission,
    TinyLFU,
    make_admission,
)
from repro_torch.core.cache import CacheEntry, CacheStats, DataCache  # noqa: F401
from repro_torch.core.controller import (  # noqa: F401
    LLMController,
    ProgrammaticController,
    ReadPlan,
    make_controller,
)
from repro_torch.core.distributed_cache import PodLocalCacheRouter  # noqa: F401
from repro_torch.core.policies import POLICIES, Policy, make_policy  # noqa: F401
from repro_torch.core.tools import (  # noqa: F401
    ToolRegistry,
    ToolResult,
    ToolSpec,
    make_cache_tools,
)
from repro_torch.core.traffic import (  # noqa: F401
    ArrivalProcess,
    ClosedLoopTraffic,
    DiurnalTraffic,
    MMPPTraffic,
    PoissonTraffic,
    SessionArrival,
    TrafficStats,
    find_knee,
    make_traffic,
    slo_attainment,
)
