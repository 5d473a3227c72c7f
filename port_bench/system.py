"""The system under test, built from a configuration file.

The only module of the benchmark that imports the program (`repro_torch`):
it turns a configuration's groups into the port's server objects and names
the shared modules the checks observe.  A configuration with "shards" > 1
is a `ShardedTwinServer` of identical in-process shards; one shard is a
plain `TwinServer`.  With "topology": "federated" it is a
`FederatedTwinServer` of "shards" spawned worker processes (no journal,
no chaos, no front door), whose worker entry `build` points at the
benchmark's own (workers.py) while the workers start; the checks read a
worker's state through `snapshot_state()` on the wire (`WorkerState`).
"""
from __future__ import annotations

import contextlib

TOPOLOGIES = ("in_process", "federated")


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


def federated(cfg: dict) -> bool:
    """Whether the configuration's shards are worker processes."""
    topology = cfg.get("topology", "in_process")
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}")
    return topology == "federated"


def build(cfg: dict, seed: int, device, worker_main=None):
    """The configuration's server on `device`, every twin registered in id
    order (twin i on shard i mod shards).  A federated one starts its
    workers with `worker_main` as their entry (workers.py's `Host.entry`)."""
    from repro_torch.twin import ShardedTwinConfig, ShardedTwinServer
    from repro_torch.twin.server import TwinServer
    scfg = server_config(cfg, seed)
    if federated(cfg):
        from repro_torch.twin import federation
        real = federation._worker_main
        federation._worker_main = worker_main
        try:
            srv = federation.FederatedTwinServer(
                federation.FederatedTwinConfig.uniform(
                    scfg, cfg["shards"],
                    rebalance_every=cfg["rebalance_every"],
                    start_method="spawn"), device=device)
        finally:
            federation._worker_main = real
    elif cfg["shards"] == 1:
        srv = TwinServer(scfg, device=device)
    else:
        srv = ShardedTwinServer(ShardedTwinConfig.uniform(
            scfg, cfg["shards"], rebalance_every=cfg["rebalance_every"]),
            device=device)
    for i in range(cfg["twins"]):
        srv.register(i)
    return srv


def shards(srv) -> list:
    """The `TwinServer`s of a server, in shard order; a federated server's
    workers as `WorkerState`s."""
    if hasattr(srv, "workers"):
        return [WorkerState(srv, i) for i in range(len(srv.workers))]
    return list(srv.shards) if hasattr(srv, "shards") else [srv]


class WorkerState:
    """One worker of a federated server as the checks read a shard: its
    `snapshot_state()` over the wire, the host arrays made tensors on the
    coordinator's device."""

    def __init__(self, srv, index: int):
        self.srv, self.index = srv, index

    def snapshot_state(self) -> dict:
        from repro_torch.twin import wire
        blob = self.srv.workers[self.index].request(
            wire.SnapshotCmd(), wire.SnapshotBlob, self.srv.cfg.tick_timeout_s)
        return _tensors(blob.unpack(), self.srv.device)


def _tensors(tree, device):
    import numpy as np
    import torch
    if isinstance(tree, np.ndarray) and tree.dtype != object:
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_tensors(v, device) for v in tree)
    return tree


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


@contextlib.contextmanager
def kernel_shapes(shapes: dict):
    """While open, the operand shapes of every call of a kernel entry point
    are appended to `shapes[name]`."""
    import torch
    saved = []
    for name, (mod, attr) in kernel_modules().items():
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def entry(*a, _fn=fn, _name=name, **k):
            shapes.setdefault(_name, []).append(
                [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)])
            return _fn(*a, **k)
        setattr(mod, attr, entry)
    try:
        yield shapes
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's CUDA library."""
    from repro_torch.kernels import backend
    backend.build_library()
    backend.load_library()


__all__ = ["server_config", "federated", "build", "shards", "WorkerState",
           "shard_of", "kernel_modules", "kernel_shapes", "build_kernels"]
