"""Dry-run: plan every (architecture x input shape) cell for one H100
without allocating anything, as the JAX package's launch/dryrun.py plans
its TPU meshes.

For each cell this builds the exact program the launcher runs
(launch/cells.py), runs it on meta tensors under the op counter
(launch/opcount.py), and writes one JSON per cell under --out: memory
(arguments, outputs, the traced peak above them, and whether the total
fits the card's HBM), FLOPs and bytes, the hand-written kernels reached,
and the roofline terms.  The keys are JAX's where their meaning carries
over; `trace_s` stands where JAX has `compile_s`, and the collectives are
0 on one card.  There is no --mesh (one card has one mesh) and no
--save-hlo (PyTorch writes no program text).  --batch and --seq-len plan
a shape's program at another size (a cell named e.g. train_4x1024).
launch/roofline.py renders the records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch rwkv6-3b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.roofline
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, Shape, get_arch, list_archs
from repro_torch.launch.cells import _model_flops, build_cell, trace_cell
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.opcount import roofline_terms
from repro_torch.launch.roofline import MESH

__all__ = ["run_cell", "plan", "main"]


def plan(arch: str, shape: str | Shape, *, grad_accum: int | None = None,
         cfg_overrides: dict | None = None) -> dict:
    """Build and trace one cell; returns its record (no file written)."""
    mesh = make_production_mesh()
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, grad_accum=grad_accum,
                      cfg_overrides=cfg_overrides)
    oc = trace_cell(cell)
    trace_s = time.perf_counter() - t0
    mem = oc.memory()
    mem["fits_hbm"] = bool(mem["total_bytes"] <= HW.HBM_BYTES)
    flops = oc.flops + oc.kernel_flops
    nbytes = oc.bytes + oc.kernel_bytes
    terms = roofline_terms(
        flops=flops, bytes_accessed=nbytes, wire_bytes=0.0,
        model_flops_per_device=_model_flops(cell, cell.shape) / mesh.size,
        peak_flops=HW.PEAK_BF16_FLOPS, hbm_bw=HW.HBM_BW, ici_bw=HW.ICI_BW)
    top = sorted(oc.by_op.items(), key=lambda kv: -kv[1][2])[:12]
    return {
        "arch": arch, "shape": cell.shape.name, "mesh": MESH,
        "n_devices": mesh.size,
        "batch": cell.shape.global_batch, "seq_len": cell.shape.seq_len,
        "trace_s": round(trace_s, 1),
        "n_params": cell.n_params, "n_active_params": cell.n_active_params,
        "memory": mem,
        "cost": {"flops": flops, "bytes_accessed": nbytes,
                 # the registry's products and attention, the rest of
                 # the ops' bytes, and the kernels' own work apart:
                 "op_flops": oc.flops, "op_bytes": oc.bytes,
                 "kernel_flops": oc.kernel_flops,
                 "kernel_bytes": oc.kernel_bytes, "aten_ops": oc.ops},
        "kernels": oc.kernels,
        "collectives": {"per_op": {}, "total_wire_bytes": 0.0},
        "ops": [{"op": op, "count": n, "flops": f, "bytes": b}
                for op, (n, f, b) in top],
        "warnings": [],
        "roofline": terms,
        "status": "ok",
    }


def run_cell(arch: str, shape: str | Shape, *, out_dir: Path,
             grad_accum: int | None = None,
             cfg_overrides: dict | None = None,
             tag_suffix: str = "") -> dict:
    rec = plan(arch, shape, grad_accum=grad_accum,
               cfg_overrides=cfg_overrides)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}_{rec['shape']}_{rec['mesh']}{tag_suffix}"
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    mem, terms = rec["memory"], rec["roofline"]
    print(f"[dryrun] {tag}: trace {rec['trace_s']:.0f}s, "
          f"mem/dev {mem['total_bytes'] / 2**30:.2f} GiB "
          f"(fits={mem['fits_hbm']}), flops/dev "
          f"{rec['cost']['flops']:.3e}, wire 0.0 MiB, "
          f"dominant={terms['dominant']}, "
          f"roofline_frac={terms['roofline_fraction']:.3f}", flush=True)
    return rec


def _parse_overrides(pairs: list[str]) -> dict:
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES), help="shape (default: all)")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=None,
                    help="override grad accumulation (perf experiments)")
    ap.add_argument("--cfg", action="append", default=[],
                    help="config override key=value (perf experiments)")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (perf experiments)")
    ap.add_argument("--batch", type=int, default=None,
                    help="plan the shape at this global batch")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="plan the shape at this sequence length")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.cfg)

    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = []
    for arch in archs:
        spec = get_arch(arch)
        for shape_name in shapes:
            if shape_name in spec.skip_shapes:
                print(f"[dryrun] SKIP {arch} x {shape_name}: "
                      f"{spec.skip_shapes[shape_name][:80]}...", flush=True)
                continue
            shape = SHAPES[shape_name]
            if args.batch or args.seq_len:
                B = args.batch or shape.global_batch
                T = args.seq_len or shape.seq_len
                shape = dataclasses.replace(
                    shape, name=f"{shape.kind}_{B}x{T}", global_batch=B,
                    seq_len=T)
            try:
                run_cell(arch, shape, out_dir=out_dir,
                         grad_accum=args.grad_accum,
                         cfg_overrides=overrides or None,
                         tag_suffix=args.tag)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape_name, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape_name}: {e}",
                      flush=True)
                traceback.print_exc()
                if args.fail_fast:
                    raise
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for f in failures:
            print("   ", *f)
        raise SystemExit(1)
    print("[dryrun] all requested cells passed.")


if __name__ == "__main__":
    main()
