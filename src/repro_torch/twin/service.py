"""The stable serving API: the `TwinService` protocol and shared config bases.

Three servers implement the same serving surface at three scales:

    TwinServer            one process, one ring/fleet/theta store
    ShardedTwinServer     one process, N in-process shards + slot federation
                          (twin/sharded.py)
    FederatedTwinServer   one coordinator process, N shard-worker SUBPROCESSES
                          (twin/federation.py) behind a versioned wire format
                          (twin/wire.py)

The process split is what forces the protocol: a coordinator cannot reach
into a worker's records or theta store, so everything a caller may depend on
is a method on this surface, and telemetry producers, the front door
(`twin.wire.IngestFrontDoor`) and the conformance tests run unchanged
against all three.

The deadline lives in ONE base (`DeadlineConfig`) that every server config
extends.  The fleet-topology knobs a sharded and a federated deployment
share (global slot budget, per-shard grant floor, rebalance cadence,
pressure smoothing, recovery and chaos schedules) live in
`FleetTopologyConfig`, which both `ShardedTwinConfig` and
`FederatedTwinConfig` extend; it also owns the mapping onto the
scheduler-level `FederationConfig` (`make_federation`), so the two
deployment shapes cannot drift.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Protocol, runtime_checkable

from repro_torch.twin.recovery import ChaosConfig, RecoveryConfig
from repro_torch.twin.scheduler import FederationConfig

__all__ = ["TwinService", "DeadlineConfig", "FleetTopologyConfig",
           "IngestChunkLike", "conforms"]

# batch element accepted by `ingest_many`: (twin_id, y) or (twin_id, y, u)
IngestChunkLike = tuple


@runtime_checkable
class TwinService(Protocol):
    """What every twin server exposes, single-process or federated.

    Semantics every implementation honours (tests/test_torch_service.py
    holds the three to one event stream):

      * `ingest` stages telemetry host-side and never blocks on device work;
        `force=True` bypasses staging backpressure (crash-recovery replay).
      * `ingest_many` is the batched form, one call per producer flush;
        returns the number of SAMPLES staged.
      * `tick` runs one full serving cycle and returns a report with at
        least `.events` (guard transitions), `.latency_s`, `.deadline_met`,
        `.n_twins`, `.n_active`.
      * `drain` is the ingest barrier: every sample whose `ingest` returned
        before the call is visible to the next tick.
      * `predict` rolls the deployed model forward from the newest
        telemetry.
      * `scenario` answers a batched what-if query (twin/scenario.py); under
        deadline pressure the degradation ladder may shrink K or refuse
        with `ScenarioRefused`.
      * `snapshot_state` returns a host-copyable tree sufficient to rebuild
        the serving state (one sub-tree per shard for multi-shard services).
      * `close` releases background threads and processes; idempotent.
    """

    def register(self, twin_id: int) -> Any: ...

    def ingest(self, twin_id: int, y, u=None, *,
               force: bool = False) -> None: ...

    def ingest_many(self, batch: Iterable[IngestChunkLike], *,
                    force: bool = False) -> int: ...

    def deploy(self, twin_id: int, theta) -> None: ...

    def deploy_many(self, twin_ids, thetas) -> None: ...

    def tick(self) -> Any: ...

    def drain(self) -> None: ...

    def predict(self, twin_id: int, horizon: int, us=None): ...

    def scenario(self, twin_id: int, horizon: int, us=None,
                 k: int | None = None): ...

    def snapshot_state(self) -> dict: ...

    def latency_summary(self) -> dict: ...

    def stage_summary(self) -> dict: ...

    def reset_latency_stats(self) -> None: ...

    def close(self) -> None: ...


_PROTOCOL_METHODS = tuple(
    name for name in vars(TwinService)
    if not name.startswith("_") and callable(getattr(TwinService, name)))


def conforms(obj) -> list[str]:
    """Names from the `TwinService` surface that `obj` is missing (empty
    list = structurally conformant); a readable diff where `isinstance`
    only says no."""
    return [name for name in _PROTOCOL_METHODS
            if not callable(getattr(obj, name, None))]


# --------------------------------------------------------------------------- #
# shared config bases
# --------------------------------------------------------------------------- #
@dataclass(frozen=True, kw_only=True)
class DeadlineConfig:
    """The mission refresh budget, declared once.

    `deadline_s` is SECONDS; the 1.0 s default is the paper's margin -- 5x
    under the 5 s human-pilot reaction time.  `TwinServerConfig` inherits
    it; fleet configs override the default to None, meaning "the tightest
    per-shard deadline" -- set it to gate the WHOLE fleet tick instead.
    """
    deadline_s: float = 1.0


@dataclass(frozen=True, kw_only=True)
class FleetTopologyConfig(DeadlineConfig):
    """Fleet-shape knobs shared by in-process sharding and multi-process
    federation (`ShardedTwinConfig`, `FederatedTwinConfig`)."""
    deadline_s: float | None = field(default=None, kw_only=True)
    total_slots: int | None = None    # global active-refit budget (None: the
                                      # sum of the physical pools)
    min_shard_slots: int = 1          # per-shard grant floor
    rebalance_every: int = 4          # federation period (ticks)
    pressure_smooth: float = 0.5      # EMA on the pressure signal
    recovery: RecoveryConfig | None = None
                                      # per-shard checkpointing + journal +
                                      # supervised restart (twin/recovery.py)
    chaos: ChaosConfig | None = None  # injected failure schedule (tests,
                                      # chip_smoke.py; None in production)

    def make_federation(self, pools: list[int]) -> FederationConfig:
        """The scheduler-level federation for these physical slot pools --
        the one place the config names map onto `FederationConfig`'s."""
        total = sum(pools) if self.total_slots is None else self.total_slots
        return FederationConfig(total_slots=total,
                                min_shard_slots=self.min_shard_slots,
                                pressure_smooth=self.pressure_smooth)
