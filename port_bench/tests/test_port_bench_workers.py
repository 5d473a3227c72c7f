"""A federated configuration: the check and the trace reach the worker
processes, a fault planted inside the workers makes `correct` false, and
a module of JAX loaded in a worker fails the run.
The runs skip the look for a card and serve 64 twins in 2 spawned workers
on the CPU (the plain path)."""
from __future__ import annotations

import pytest

from port_bench import run, workers
from port_bench.tests.conftest import args, small_cell

SEED = 3_000_000_191
CELL = "f8-fed10k.steady"


def federated_cell():
    cell = small_cell(CELL)
    assert cell.cfg["topology"] == "federated"
    cell.cfg["shards"] = 2
    cell.cfg["server"]["max_twins"] = 32
    cell.traffic["ticks"] = 400
    return cell


def _stale_step():
    """In a worker: every refit step returns the state it was given."""
    from repro_torch.core.fleet import FleetMerinda
    real = FleetMerinda.train_step_per_slot

    def stale(self, state, y_win, u_win):
        _, loss, ok = real(self, state, y_win, u_win)
        return state, loss, ok
    FleetMerinda.train_step_per_slot = stale


def _jax_module():
    """In a worker: a module under one of the names a run may not hold."""
    import sys
    import types
    sys.modules["flax"] = types.ModuleType("flax")


def test_a_federated_run_reads_every_worker(cpu):
    cell = federated_cell()
    result, session = run.execute(cell, args(SEED, 2.0, trace=1), cpu)
    assert result["correct"], result["checks"]
    records = session.recorder.records
    assert len(records) == cell.traffic["check"]["ticks"]
    every = set(cell.limits["every_checked_tick"])
    for rec in records:
        assert len(rec["pre"]) == len(rec["post"]) == 2
        assert {shard for shard, _, _ in rec["calls"]} == {0, 1}
        assert every <= rec["read"]
    assert result["workers"]["count"] == 2
    for calls in result["workers"]["recorded_calls"]:
        assert calls.get("train") and calls.get("score"), calls
    assert result["window"]["ticks"] > 0
    names = {m["name"] for m in cell.layer}
    assert {"worker_tick_ms", "federation_wait_ms", "flush_host_ms",
            "refit_ms", "tick_mfu"} <= names
    for name in ("worker_tick_ms", "worker_ingest_ms", "federation_wait_ms",
                 "flush_host_ms", "refit_ms", "tick_mfu", "ingest_host_ms"):
        assert result["metrics"][name]["value"] > 0, name
    assert (result["metrics"]["worker_tick_ms"]["value"]
            <= result["window"]["tick_ms"]["max"])


def test_a_step_that_returns_its_state_unchanged_in_the_workers(
        cpu, monkeypatch):
    monkeypatch.setattr(workers, "SETUP", [_stale_step])
    result, _ = run.execute(federated_cell(), args(SEED + 2, 2.0), cpu)
    assert not result["correct"]
    assert result["checks"]["refit_step_rel"]["value"] >= 0.99


def test_a_module_of_jax_in_a_worker_fails_the_run(cpu, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(workers, "SETUP", [_jax_module])
    with pytest.raises(SystemExit) as exited:
        run.execute(federated_cell(), args(SEED + 4, 1.0), cpu)
    assert exited.value.code == 3
    assert "worker processes: ['flax']" in capsys.readouterr().err


@pytest.mark.parametrize("topology", ["in_process", "federated"])
def test_topology_is_read_from_the_configuration(topology):
    from port_bench import system
    cfg = dict(run.load_cell(CELL).cfg, topology=topology)
    assert system.federated(cfg) == (topology == "federated")
    with pytest.raises(ValueError):
        system.federated(dict(cfg, topology="mesh"))
    assert not system.federated(run.load_cell("f8-fleet10k.steady").cfg)
