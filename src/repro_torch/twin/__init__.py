"""Online digital-twin serving on the CUDA card: sense -> recover -> predict
-> guard, continuously, for a whole tracked fleet on a bounded compute budget.

The STABLE surface is the `TwinService` protocol (service.py) and the three
servers that implement it at three scales, with the names the JAX package's
`repro.twin` exports:

    server = TwinServer(TwinServerConfig(...))            # one process
    server = ShardedTwinServer(ShardedTwinConfig.uniform(cfg, shards))
    server = FederatedTwinServer(FederatedTwinConfig.uniform(cfg, workers))

Each takes `device=` (None: the CUDA card, raising without one; "cpu": the
plain PyTorch path).  Every shard and every worker process runs the serving
tick, which launches the GRU-scan and RK4 kernels (csrc/) on the card.
"""
from repro_torch.twin.federation import (FederatedTwinConfig,
                                         FederatedTwinServer,
                                         FederationCoordinator, ShardWorker)
from repro_torch.twin.monitor import (DivergenceGuard, GuardConfig,
                                      GuardEvent, GuardInstruments,
                                      GuardRotation)
from repro_torch.twin.packed import PackedFleet, fleet_pressure, fleet_scores
from repro_torch.twin.recovery import (ChaosConfig, ChaosInjector,
                                       DegradationConfig, DegradationEvent,
                                       DegradationPolicy, RecoveryConfig,
                                       ShardFailure, TelemetryJournal,
                                       TwinCheckpointer)
from repro_torch.twin.scenario import (ScenarioConfig, ScenarioRefused,
                                       ScenarioResult, ScenarioRunner,
                                       effective_k)
from repro_torch.twin.scheduler import (FederationConfig,
                                        PackedRefitScheduler, PriorityBuckets,
                                        RefitScheduler, SchedulerConfig,
                                        SchedulePlan, SchedulerMetrics,
                                        SlotFederation, TwinRecord)
from repro_torch.twin.server import (TickReport, TorchInitSource, TwinServer,
                                     TwinServerConfig)
from repro_torch.twin.service import (DeadlineConfig, FleetTopologyConfig,
                                      TwinService, conforms)
from repro_torch.twin.sharded import (ShardedTickReport, ShardedTwinConfig,
                                      ShardedTwinServer)
from repro_torch.twin.stream import (RingConfig, StagingBuffer,
                                     StagingOverflow, TelemetryRing,
                                     prepare_flush)
from repro_torch.twin.wire import FrontDoorClient, IngestFrontDoor

# the stable serving surface: the protocol, the three servers, their
# configs, and the report and event types callers consume
_STABLE = [
    "TwinService", "conforms",
    "DeadlineConfig", "FleetTopologyConfig",
    "TwinServer", "TwinServerConfig", "TickReport",
    "ShardedTwinServer", "ShardedTwinConfig", "ShardedTickReport",
    "FederatedTwinServer", "FederatedTwinConfig",
    "FrontDoorClient", "IngestFrontDoor",
    "GuardConfig", "GuardEvent",
    "ScenarioConfig", "ScenarioResult", "ScenarioRefused",
    "RecoveryConfig", "ChaosConfig",
    "DegradationConfig", "DegradationEvent",
]

# building blocks exported for tests, tools and extension authors; they may
# change without deprecation (packed layouts, wire framing, scheduler
# internals)
_INTERNAL = [
    "FederationCoordinator", "ShardWorker",
    "DivergenceGuard", "GuardInstruments", "GuardRotation",
    "ScenarioRunner", "effective_k",
    "FederationConfig", "PackedFleet", "PackedRefitScheduler",
    "PriorityBuckets", "RefitScheduler", "SchedulerConfig", "SchedulePlan",
    "SchedulerMetrics", "SlotFederation", "TwinRecord", "TorchInitSource",
    "fleet_pressure", "fleet_scores",
    "ChaosInjector", "DegradationPolicy", "ShardFailure",
    "TelemetryJournal", "TwinCheckpointer",
    "RingConfig", "StagingBuffer", "StagingOverflow", "TelemetryRing",
    "prepare_flush",
]

__all__ = _STABLE + _INTERNAL
