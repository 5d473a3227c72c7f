"""The port stands alone: it imports without JAX and never imports the JAX
package, and its entry points refuse to fall back to the CPU silently."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

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
    from repro_torch.core.merinda import MerindaConfig
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
