"""Roofline report: renders the dry-run JSONs in artifacts/dryrun/ as
tables, as the JAX package's launch/roofline.py (stdlib only).

Usage:  PYTHONPATH=src python -m repro_torch.launch.roofline \\
            [--dir artifacts/dryrun]
Writes artifacts/roofline.md: the one-card table and the pass matrix.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

__all__ = ["load_records", "render_table", "render_summary", "main"]

MESH = "1xH100"


def load_records(d: Path) -> list[dict]:
    recs = [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]
    return sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"]))


def _fmt_t(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def render_table(recs: list[dict], mesh: str = MESH) -> str:
    rows = [r for r in recs if r["mesh"] == mesh]
    out = [
        f"| arch | shape | compute | memory | collective | dominant | "
        f"GiB/dev | fits | MODEL/HLO flops | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        t = r["roofline"]
        m = r["memory"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_t(t['compute_s'])} | "
            f"{_fmt_t(t['memory_s'])} | {_fmt_t(t['collective_s'])} | "
            f"{t['dominant'].replace('_s', '')} | "
            f"{m['total_bytes'] / 2**30:.2f} | "
            f"{'yes' if m['fits_hbm'] else 'NO'} | "
            f"{t['useful_flop_ratio']:.3f} | "
            f"{t['roofline_fraction']:.3f} |")
    return "\n".join(out)


def render_summary(recs: list[dict]) -> str:
    """Pass matrix over the one mesh: every cell that wrote a record."""
    cells: dict[tuple, set] = {}
    for r in recs:
        cells.setdefault((r["arch"], r["shape"]), set()).add(r["mesh"])
    out = [f"| arch | shape | {MESH} |", "|---|---|---|"]
    for (a, s), meshes in sorted(cells.items()):
        out.append(f"| {a} | {s} | {'pass' if MESH in meshes else '—'} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--out", default="artifacts/roofline.md")
    args = ap.parse_args(argv)
    recs = load_records(Path(args.dir))
    doc = [f"# Roofline table (one NVIDIA H100, {MESH}, per-device terms)",
           "", render_table(recs, MESH), "",
           "# Pass matrix", "", render_summary(recs), ""]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(doc))
    print("\n".join(doc))


if __name__ == "__main__":
    main()
