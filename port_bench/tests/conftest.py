"""Paths and a small cell for the benchmark's CPU tests.

Run from the repository root:  python -m pytest -q port_bench/tests
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def small_cell(name: str):
    """Cell `name` at a size the CPU runs in seconds: 8 twins on one
    server, or 64 on its shards of 16 with a guard of 8; short traffic."""
    from port_bench import run
    cell = run.load_cell(name)
    cfg = copy.deepcopy(cell.cfg)
    if cfg["shards"] > 1:
        cfg["twins"] = 64
        cfg["server"].update(max_twins=16, guard_budget=8)
    else:
        cfg["twins"] = 8
        cfg["server"]["max_twins"] = 8
    cell.cfg = cfg
    t = cell.traffic
    t.update(ticks=40, warmup_ticks=12, trace_ticks=2)
    t["check"] = dict(t["check"], skip=2, ticks=3)
    if t.get("queries"):
        t["queries"] = dict(t["queries"], per_tick=2)
    return cell


def args(seed: int, seconds: float = 1.0, trace: int = 0):
    return SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
