"""Nothing in the benchmark imports JAX or the JAX package, the reference
imports nothing of the program, and no module reads the JAX package's
benchmarks."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
# the yardstick: it may not take anything from the program it measures
YARDSTICK = {"reference.py", "telemetry.py", "work.py", "check.py",
             "trace.py", "control.py"}
PROGRAM = "repro_torch"


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def string_paths(path: Path) -> list[str]:
    """String constants that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_modules_found():
    assert len(MODULES) > 20


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & NEVER, path


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_path_into_benchmarks(path):
    assert not [s for s in string_paths(path) if "benchmarks" in s], path


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_yardstick_takes_nothing_from_the_program(name):
    path = HERE / name
    assert PROGRAM not in top_level_imports(path)
    assert not [s for s in string_paths(path) if PROGRAM in s]


def test_metric_readers_take_nothing_from_the_program():
    for path in (HERE / "metrics").glob("*.py"):
        assert not top_level_imports(path) & (NEVER | {PROGRAM}), path


def test_whole_name_compare():
    """The port's name begins with the JAX package's: names compare whole."""
    assert PROGRAM.split(".")[0] not in NEVER
    assert "repro" in NEVER
