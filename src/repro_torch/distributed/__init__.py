"""Distributed-training support for the port; so far the fault-tolerance
pieces (checkpoints, sharding and elastic resharding are not ported yet)."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FailureInjector,
    HeartbeatMonitor,
    PreemptionGuard,
    WorkerFailure,
)
