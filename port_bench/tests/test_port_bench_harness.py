"""BENCHMARK.json keeps to its schema, every cell resolves to its files,
new cells, mixes and metrics are found as new files alone, and run.py
refuses to run without a card or outside a whole checkout."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [
        c["source"] for c in BENCH["configs"]] + [
        m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_metrics_keep_to_the_schema():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        moved = e2e[m["moves"]].get("workloads", CELLS)
        for w in m.get("workloads", moved):
            assert w in moved
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = run.load_cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.e2e} >= {"setup_s"}
    assert len(cell.e2e) >= 2 and cell.layer
    for m in cell.layer:
        assert callable(run.metric_reader(m["name"]))
    conf = next(c for c in BENCH["configs"]
                if c["name"] == next(w for w in BENCH["workloads"]
                                     if w["name"] == name)["config"])
    assert conf["file"].startswith("port_bench/configs/")
    assert cell.cfg["precision"] == "float32"
    lim = cell.limits
    assert set(lim) <= {"every_checked_tick", "every_checked_query", "limits"}
    assert lim["limits"]["exact_mismatch"] == 0
    assert lim["limits"]["unread"] == 0 and lim["limits"]["chain_mismatch"] == 0
    # the refit's and the guard's numbers are read on every checked tick,
    # the what-if answers' on every checked query
    assert {"refit_loss_rel", "refit_grad_rel", "refit_step_rel",
            "guard_score_rel"} <= set(lim["every_checked_tick"])
    assert set(lim["every_checked_tick"]) <= set(lim["limits"])
    queries = set(lim.get("every_checked_query", ()))
    assert queries <= set(lim["limits"])
    assert bool(queries) == bool(cell.traffic.get("queries"))


def _copy(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "port_bench", dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_new_cell_mix_and_metric_are_found_as_files(tmp_path):
    dst = _copy(tmp_path)
    pb = dst / "port_bench"
    mix = json.loads((pb / "traffic" / "steady.json").read_text())
    mix["mix"] = "a burstier mix"
    (pb / "traffic" / "storm.json").write_text(json.dumps(mix))
    (pb / "limits" / "f8-fleet10k.storm.json").write_text(
        (pb / "limits" / "f8-fleet10k.steady.json").read_text())
    (pb / "metrics" / "ticks_seen.py").write_text(
        "def read(run):\n    return float(len(run.ticks)) or None\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "f8-fleet10k.storm",
                               "config": "f8-fleet10k", "traffic": "storm",
                               "chips": 1, "why": "bursts"})
    bench["per_layer"].append({"name": "ticks_seen", "unit": "ticks",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "samples_per_s",
                               "workloads": ["f8-fleet10k.storm"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from port_bench import run;"
        "c = run.load_cell('f8-fleet10k.storm');"
        "r = run.metric_reader('ticks_seen');"
        "print(c.traffic['mix'], [m['name'] for m in c.layer][-1],"
        " r(type('R', (), {'ticks': [1, 2]})))")
    out = subprocess.run([sys.executable, "-c", code, str(dst)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["a", "burstier", "mix", "ticks_seen",
                                  "2.0"]


def test_run_exits_without_a_card():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_run_exits_in_a_checkout_of_the_benchmark_alone(tmp_path):
    dst = _copy(tmp_path)
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=dst, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
