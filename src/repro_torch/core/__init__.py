"""LLM-dCache core, the port's copy of the reference's ``repro.core``.

Cache mechanism (``cache``), eviction policies with natural-language
descriptions (``policies``), cross-session admission with a shared
frequency sketch (``admission``), cache ops as callable tools (``tools``),
programmatic vs GPT-driven controllers (``controller``), prompt templates
(``prompts``), endpoint pools (``endpoints``), fault schedules (``faults``)
and the plan cache (``plan_cache``). Framework-free numpy and Python, copied
line for line so that Tables I-III stay bit-identical; the multi-pod and
traffic modules that only the concurrent engine needs are not ported yet.
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
from repro_torch.core.policies import POLICIES, Policy, make_policy  # noqa: F401
from repro_torch.core.tools import (  # noqa: F401
    ToolRegistry,
    ToolResult,
    ToolSpec,
    make_cache_tools,
)
