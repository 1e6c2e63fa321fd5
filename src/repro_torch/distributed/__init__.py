"""Distributed-training support for the port: checkpoints, sharding rules,
elastic resharding and fault tolerance (``repro.distributed``)."""
from repro_torch.distributed.checkpoint import Checkpointer  # noqa: F401
from repro_torch.distributed.elastic import (  # noqa: F401
    mesh_transition_plan,
    reshard_tree,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FailureInjector,
    HeartbeatMonitor,
    PreemptionGuard,
    WorkerFailure,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    constrain,
    logical_to_spec,
    multi_pod_rules,
    named_sharding,
    sharding_context,
    single_pod_rules,
    tree_shardings,
)
