from repro_torch.agent.geollm.datastore import (  # noqa: F401
    CLASSES,
    DATASETS,
    GeoDataStore,
    GeoFrame,
    all_keys,
    synth_frame,
)
from repro_torch.agent.geollm.evaluator import Report, evaluate, rouge_l  # noqa: F401
from repro_torch.agent.geollm.simclock import LatencyModel, SimClock  # noqa: F401
from repro_torch.agent.geollm.workload import (  # noqa: F401
    Task,
    WorkloadSampler,
    compute_gold,
    make_benchmark,
    model_check,
)
