"""The readings that the limits of the correctness check are set from.

    python3 port_bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...]

Runs the cell once for each seed in one process (the library and the CUDA
context are set up once) and prints, a JSON line a seed, the program's
reading of every compared number; for each control seed also the
control's: the plain reference in TF32, the nearest precision below the
configuration's float32, standing in the program's place on the same
observed ticks and queries.  The last line gives, for each number, the
largest program reading (the lower end of its limit) and the smallest
control reading (the upper end).  The benchmark's own runs never run the
control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
for p in (HERE.parent / "src", HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from port_bench import check, run  # noqa: E402


def readings(cell, seed: int, seconds: float, control: bool, device):
    args = SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    result, session = run.execute(cell, args, device)
    out = {"seed": seed, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "program": {k: v["value"] for k, v in result["checks"].items()}}
    if control:
        ctl, _ = check.evaluate(session.recorder, session.queries,
                                session.tele, cell.cfg, device, control=True)
        out["control"] = ctl
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available():
        run.fail("no CUDA device")
    device = torch.device("cuda", 0)
    cell = run.load_cell(args.workload)
    lower: dict = {}
    upper: dict = {}
    for seed in list(args.seeds) + list(args.control_seeds):
        out = readings(cell, seed, args.seconds,
                       seed in args.control_seeds, device)
        print(json.dumps(out), flush=True)
        for k, v in out["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in out.get("control", {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
