"""The system under test, built from a configuration file.

The only module of the benchmark that imports the program (`repro_torch`):
it turns a configuration's groups into the port's server objects and names
the shared modules the checks observe.  A configuration with "shards" > 1
is a `ShardedTwinServer` of identical in-process shards; one shard is a
plain `TwinServer`.
"""
from __future__ import annotations


def server_config(cfg: dict, seed: int):
    from repro_torch.core.merinda import MerindaConfig
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.scenario import ScenarioConfig
    from repro_torch.twin.server import TwinServerConfig
    return TwinServerConfig(
        merinda=MerindaConfig(**cfg["merinda"]),
        guard=GuardConfig(**cfg["guard"]),
        scenario=ScenarioConfig(**cfg["scenario"]),
        seed=seed, **cfg["server"])


def build(cfg: dict, seed: int, device):
    """The configuration's server on `device`, every twin registered in id
    order (twin i on shard i mod shards)."""
    from repro_torch.twin import ShardedTwinConfig, ShardedTwinServer
    from repro_torch.twin.server import TwinServer
    scfg = server_config(cfg, seed)
    if cfg["shards"] == 1:
        srv = TwinServer(scfg, device=device)
    else:
        srv = ShardedTwinServer(ShardedTwinConfig.uniform(
            scfg, cfg["shards"], rebalance_every=cfg["rebalance_every"]),
            device=device)
    for i in range(cfg["twins"]):
        srv.register(i)
    return srv


def shards(srv) -> list:
    """The `TwinServer`s of a server, in shard order."""
    return list(srv.shards) if hasattr(srv, "shards") else [srv]


def shard_of(cfg: dict, twin: int) -> tuple[int, int]:
    """(shard, ring row) of a twin registered by `build`."""
    return twin % cfg["shards"], twin // cfg["shards"]


def kernel_modules():
    """The modules whose kernel entry points the traced run observes:
    {name: (module, attribute)}."""
    from repro_torch.kernels.gru import ops as gru_ops
    from repro_torch.kernels.rk4 import ops as rk4_ops
    return {"gru": (gru_ops, "gru_scan_kernel"),
            "rk4": (rk4_ops, "rk4_poly_kernel")}


def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA library."""
    from repro_torch.kernels import backend
    backend.build_library()
    backend.load_library()


__all__ = ["server_config", "build", "shards", "shard_of", "kernel_modules",
           "build_kernels"]
