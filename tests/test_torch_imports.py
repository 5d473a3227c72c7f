"""The port stands alone: it imports without JAX and never imports the JAX
package, and its entry points refuse to fall back to the CPU silently."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(k == 'repro' or k.startswith(('repro.', 'jax.'))"
            " for k in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert len(_modules()) > 20
    # the crash-safety, fleet and LM-zoo slices' modules are among them
    assert {"repro_torch.train.checkpoint", "repro_torch.twin.recovery",
            "repro_torch.data.pipeline",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.twin.service", "repro_torch.twin.wire",
            "repro_torch.twin.sharded",
            "repro_torch.twin.federation", "repro_torch.models.attention",
            "repro_torch.models.mamba2",
            "repro_torch.configs.zamba2_7b", "repro_torch.models.moe",
            "repro_torch.models.encdec", "repro_torch.configs.mixtral_8x22b",
            "repro_torch.configs.arctic_480b",
            "repro_torch.configs.whisper_large_v3",
            # LM training
            "repro_torch.data.tokens", "repro_torch.train.loop",
            "repro_torch.train.train_state",
            "repro_torch.distributed.compression"} <= set(_modules())


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core.fleet import FleetConfig, FleetMerinda
    from repro_torch.core.merinda import Merinda, MerindaConfig
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.twin.monitor import GuardConfig
    from repro_torch.twin.server import TwinServer, TwinServerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg = MerindaConfig(n=2, m=1, hidden=8, head_hidden=8)
    cfg = TwinServerConfig(merinda=mcfg, max_twins=4, capacity=64, window=8,
                           stride=4, windows_per_twin=2,
                           guard=GuardConfig(window=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TwinServer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetMerinda(FleetConfig(merinda=mcfg, fleet=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Merinda(mcfg).init()
    params = Merinda(mcfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    assert params["gru"]["wh"].device == torch.device("cpu")

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.models.zoo import build
    from repro_torch.serve.engine import ServeEngine
    assert {"mixtral-8x22b", "arctic-480b", "whisper-large-v3"} <= set(
        list_archs()) and len(list_archs()) == 10
    for arch in list_archs():
        api = build(get_arch(arch).smoke)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(api)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.init(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.cache_init(2, 64)
        assert ServeEngine(api, device="cpu").device == torch.device("cpu")

    from repro_torch.core.emily import Emily, EmilyConfig
    from repro_torch.core.pinn_sr import PinnSR, PinnSRConfig
    from repro_torch.launch.train import parser, train_lm, train_merinda
    from repro_torch.systems.f8_crusader import F8Crusader
    from repro_torch.systems.simulate import (simulate, simulate_batch,
                                              simulate_from)
    from repro_torch.twin.packed import (PackedFleet, fleet_pressure,
                                         fleet_scores)
    from repro_torch.twin.scheduler import (PackedRefitScheduler,
                                            SchedulerConfig)
    from repro_torch.twin.stream import RingConfig, TelemetryRing
    # the reference planner, the checkpointer and the journal are host
    # code: they run without a card
    from repro_torch.twin.recovery import TelemetryJournal
    from repro_torch.twin.scheduler import RefitScheduler
    RefitScheduler(SchedulerConfig(slots=2, min_samples=4)).plan({})
    TelemetryJournal(horizon=8).append(0, np.zeros((2, 3), np.float32))
    ring_cfg = RingConfig(slots=2, capacity=16, n=3, m=1)
    sched_cfg = SchedulerConfig(slots=2, min_samples=4)
    packed = PackedFleet(4)
    score = dict(min_samples=4, sw=1.0, dw=1.0)
    gen = torch.Generator().manual_seed(0)
    calls = {
        "TelemetryRing": lambda **d: TelemetryRing(ring_cfg, **d),
        "PackedRefitScheduler": lambda **d: PackedRefitScheduler(sched_cfg,
                                                                 **d),
        "fleet_scores": lambda **d: fleet_scores(packed, k=2, **score, **d),
        "fleet_pressure": lambda **d: fleet_pressure(packed, **score, **d),
        "PackedRefitScheduler.plan_records": lambda **d: PackedRefitScheduler(
            sched_cfg, **d).plan_records({}),
        "simulate": lambda **d: simulate(F8Crusader(), gen, horizon=2, **d),
        "simulate_batch": lambda **d: simulate_batch(F8Crusader(), gen, 2,
                                                     horizon=2, **d),
        "simulate_from": lambda **d: simulate_from(
            F8Crusader(), torch.zeros(1, 3), torch.zeros(1, 2, 1), **d),
        "Emily.init": lambda **d: Emily(EmilyConfig(n=2, m=1)).init(gen,
                                                                    **d),
        "PinnSR.init": lambda **d: PinnSR(PinnSRConfig(n=2, m=1)).init(gen,
                                                                       **d),
        "train_merinda": lambda **d: train_merinda(parser().parse_args(
            ["--merinda", "lotka_volterra", "--steps", "1"]), **d),
        "train_lm": lambda **d: train_lm(parser().parse_args(
            ["--arch", "rwkv6-3b", "--smoke", "--steps", "1", "--batch",
             "2", "--seq-len", "16"]), **d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")          # the plain path still runs
