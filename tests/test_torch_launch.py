"""The port's planner: cells, the op counter, the dry-run and the roofline
tables (launch/{cells,opcount,dryrun,roofline,mesh}.py), on the CPU.

  * `build_cell` + `trace_cell` on SMOKE configs, one per program kind
    (train, prefill, decode) for an RWKV-6, an attention, a Mamba-2 +
    shared-attention, an MoE and the encoder-decoder model: the counted
    products and attention equal `FlopCounterMode`'s on the same call
    within 1e-6 (relative); the kernels' own work is counted apart;
  * a train cell's memory: its arguments are the state and batch, every
    output of the donated state aliases an argument, and the scan runs
    once a layer (and again where the backward recomputes it);
  * each hand-written kernel on meta tensors takes the card's route: its
    outputs shaped, its work as kernels/work.py's formulas, its backward
    run (the RK4 adjoint reported as a kernel, the others replayed), no
    launch counted;
  * the parameter counts, `roofline_terms` and `render_table` against the
    JAX package's on the same inputs; the dry-run CLI's record keys (JAX's
    where they carry over), `skip_shapes`, and the rendered table.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as jax_get_arch
from repro.launch import cells as jcells
from repro.launch import hlo_analysis as jhlo
from repro.launch import roofline as jroofline
from repro.models.zoo import build as jax_build
from repro_torch.configs import SHAPES, Shape, get_arch, list_archs
from repro_torch.core.library import make_library
from repro_torch.kernels import work
from repro_torch.kernels.gru.ops import gru_scan
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.kernels.rk4.ops import rk4_poly_solve
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.launch.mesh import HW
from repro_torch.launch.opcount import OpCounter, roofline_terms
from repro_torch.train.checkpoint import tree_flatten

ARCHS = ("rwkv6-3b", "qwen3-8b", "zamba2-7b", "mixtral-8x22b",
         "whisper-large-v3")
KINDS = ("train", "prefill", "decode")
B, T = 2, 64


def _smoke(arch) -> dict:
    cfg = get_arch(arch).smoke
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _cell(arch, kind, grad_accum=2):
    return cells.build_cell(arch, Shape(f"smoke_{kind}", kind, T, B),
                            grad_accum=grad_accum,
                            cfg_overrides=_smoke(arch))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_counts_flops_as_flop_counter_mode(arch, kind):
    oc = cells.trace_cell(_cell(arch, kind))
    twin = _cell(arch, kind)
    with FlopCounterMode(display=False) as fc:
        twin.fn(*twin.arg_specs)
    want = fc.get_total_flops()
    assert want > 0
    assert abs(oc.flops - want) <= 1e-6 * want
    assert oc.ops > 0 and oc.bytes > 0 and oc.peak_bytes > 0
    scans = get_arch(arch).smoke.layer_kinds()
    n_scan = sum(k in ("rwkv6", "mamba2") for k in scans)
    if kind == "decode" or not n_scan:
        assert oc.kernels == {}
    else:
        calls = oc.kernels["linear_scan"]["calls"]
        assert calls == n_scan * (2 if kind == "train" else 1)


def test_train_cell_memory_is_its_state_and_batch():
    """rwkv6-3b SMOKE (no recomputation), 2 microbatches: the arguments are
    the state and the batch, the donated state comes back in the same
    storages but for its two int32 step counters (new tensors each step,
    as on the card), and the traced peak lies above the arguments."""
    cell = _cell("rwkv6-3b", "train")
    state, batch = cell.arg_specs
    state_bytes = sum(t.nbytes for t in tree_flatten(state)[0])
    batch_bytes = sum(t.nbytes for t in batch.values())
    oc = cells.trace_cell(cell)
    mem = oc.memory()
    assert mem["argument_bytes"] == state_bytes + batch_bytes
    assert mem["alias_bytes"] == state_bytes - 2 * 4
    assert mem["temp_bytes"] > 0
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                  + mem["output_bytes"] - mem["alias_bytes"])
    assert oc.kernels["linear_scan"]["calls"] == 2 * 2     # layers x micro
    assert cell.donate_argnums == (0,)


def test_traced_peak_counts_a_storage_once_and_frees_it():
    x = torch.empty((1024,), device="meta")
    with OpCounter() as oc:
        oc.arguments(x)
        y = x * 2                                  # 4 KiB
        views = [y[:10], y.view(32, 32), y.t() if y.ndim == 2 else y]
        z = y + 1                                  # 4 KiB more
        del y, views
        w = z * 3                                  # z's 4 KiB, w's 4 KiB
        oc.outputs(w)
    assert oc.peak_bytes == 2 * 4096
    assert oc.memory()["total_bytes"] == 4096 + 2 * 4096


@pytest.mark.parametrize("kernel", ["gru_scan", "rk4_poly", "linear_scan"])
def test_kernels_take_the_card_route_on_meta(kernel):
    meta = dict(device="meta", requires_grad=True)
    before = (gru_scan.launches, rk4_poly_solve.launches,
              linear_scan.launches)
    with OpCounter() as oc:
        if kernel == "gru_scan":
            F_, B_, T_, D, H = 3, 5, 24, 4, 32
            args = [torch.empty(s, **meta) for s in (
                (F_, B_, T_, D), (F_, B_, H), (F_, D, 3 * H),
                (F_, H, 3 * H), (F_, 3 * H))]
            hs, hT = gru_scan(*args)
            assert hs.shape == (F_, B_, T_, H) and hT.shape == (F_, B_, H)
            (hs.sum() + hT.sum()).backward()
            flops = work.gru_flops(F_, B_, T_, H, D)
            nbytes = sum(t.nbytes for t in (*args, hs, hT))
            tf32 = 0.0
        elif kernel == "rk4_poly":
            lib = make_library(3, 1, 3)
            Bk, Tk = 8, 24
            args = [torch.empty(s, **meta) for s in (
                (Bk, 3, lib.size), (Bk, 3), (Bk, Tk, 1))]
            ys = rk4_poly_solve(*args, dt=0.01, library=lib)
            assert ys.shape == (Bk, Tk + 1, 3)
            ys.sum().backward()
            assert [a.grad.shape for a in args] == [a.shape for a in args]
            idx = lib.indices_on("meta")
            flops = work.rk4_flops(Bk, Tk, 3, lib.size, idx.shape[1])
            nbytes = sum(t.nbytes for t in (*args, idx, ys))
            tf32 = 0.0
            # the backward is the adjoint kernel: reads theta, us, the
            # indices, ys and its cotangent; writes the three gradients
            assert oc.kernels["rk4_adjoint"] == {
                "calls": 1, "tf32_flops": 0.0,
                "flops": work.rk4_adjoint_flops(Bk, Tk, 3, lib.size,
                                                idx.shape[1]),
                "bytes": sum(t.nbytes for t in (args[0], args[2], idx, ys,
                                                ys, *args))}
        else:
            Bs, H, Ts, K = 2, 4, 100, 16
            q, k, w = (torch.empty((Bs, H, Ts, K), **meta) for _ in range(3))
            v = torch.empty((Bs, H, Ts, K), **meta)
            u = torch.empty((H, K), **meta)
            o, s = linear_scan(q, k, v, w, u, mode="rwkv6", chunk=32)
            assert o.shape == (Bs, H, Ts, K) and s.shape == (Bs, H, K, K)
            (o.sum() + s.sum()).backward()
            assert q.grad.shape == q.shape and u.grad.shape == u.shape
            flops, tf32 = work.scan_work(Bs * H, 1, Ts, K, K, 32, True,
                                         False)
            nbytes = sum(t.nbytes for t in (q, k, v, w, u, o, s))
    got = oc.kernels[kernel]
    assert got["calls"] == 1
    assert got["flops"] == flops and got["tf32_flops"] == tf32
    assert got["bytes"] == nbytes
    # the replayed backward's products (the RK4 one is a kernel)
    assert (oc.flops > 0) == (kernel != "rk4_poly")
    assert (gru_scan.launches, rk4_poly_solve.launches,
            linear_scan.launches) == before


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal_jax(arch):
    shape = "decode_32k" if "decode_32k" not in get_arch(
        arch).skip_shapes else "train_4k"
    cell = cells.build_cell(arch, shape)
    japi = jax_build(jax_get_arch(arch).config,
                     max_position=SHAPES[shape].seq_len)
    total, dense = jcells._count_params(japi.param_specs())
    assert (cell.n_params, cell.n_active_params) == (
        total, jcells._moe_active(japi, total, dense))


def test_build_cell_refuses_a_skipped_shape():
    arch = next(a for a in list_archs() if get_arch(a).skip_shapes)
    shape = next(iter(get_arch(arch).skip_shapes))
    with pytest.raises(ValueError, match="skips"):
        cells.build_cell(arch, shape)


@pytest.mark.parametrize("case", range(4))
def test_roofline_terms_equal_jax(case):
    rng = np.random.default_rng(case)
    kw = dict(flops=float(rng.uniform(1e12, 1e17)),
              bytes_accessed=float(rng.uniform(1e9, 1e14)),
              wire_bytes=0.0 if case < 2 else float(rng.uniform(1e6, 1e9)),
              model_flops_per_device=float(rng.uniform(1e12, 1e16)),
              peak_flops=HW.PEAK_BF16_FLOPS, hbm_bw=HW.HBM_BW,
              ici_bw=HW.ICI_BW if case < 2 else 50e9)
    assert roofline_terms(**kw) == jhlo.roofline_terms(**kw)


def _records():
    recs = []
    for i, (arch, shape) in enumerate([("rwkv6-3b", "train_4k"),
                                       ("qwen3-8b", "decode_32k"),
                                       ("zamba2-7b", "long_500k")]):
        terms = roofline_terms(
            flops=3e15 * (i + 1), bytes_accessed=2e12 / (i + 1),
            wire_bytes=0.0, model_flops_per_device=1e15,
            peak_flops=HW.PEAK_BF16_FLOPS, hbm_bw=HW.HBM_BW,
            ici_bw=HW.ICI_BW)
        recs.append({"arch": arch, "shape": shape, "mesh": "1xH100",
                     "roofline": terms,
                     "memory": {"total_bytes": 7.5e10 * (i + 0.5),
                                "fits_hbm": 7.5e10 * (i + 0.5)
                                <= HW.HBM_BYTES}})
    return recs


def test_render_table_equals_jax():
    recs = _records()
    assert roofline.render_table(recs) == jroofline.render_table(
        recs, mesh="1xH100")
    assert "| rwkv6-3b | train_4k |" in roofline.render_table(recs)
    summary = roofline.render_summary(recs)
    assert summary.splitlines()[0] == "| arch | shape | 1xH100 |"
    assert summary.count("| pass |") == 3


def test_dryrun_cli_writes_records_and_the_table(tmp_path, capsys):
    out = tmp_path / "dryrun"
    dryrun.main(["--arch", "rwkv6-3b", "--shape", "decode_32k", "--out",
                 str(out), "--cfg", "n_layers=2"])
    recs = roofline.load_records(out)
    assert len(recs) == 1
    rec = recs[0]
    # the JAX dry-run's keys, where their meaning carries over
    assert {"arch", "shape", "mesh", "n_devices", "n_params",
            "n_active_params", "memory", "cost", "collectives", "warnings",
            "roofline", "status"} <= set(rec)
    assert rec["mesh"] == "1xH100" and rec["n_devices"] == 1
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "total_bytes",
                                  "fits_hbm"}
    assert {"flops", "bytes_accessed"} <= set(rec["cost"])
    assert rec["collectives"]["total_wire_bytes"] == 0.0
    assert set(rec["roofline"]) == set(jhlo.roofline_terms(
        flops=1.0, bytes_accessed=1.0, wire_bytes=0.0,
        model_flops_per_device=1.0, peak_flops=1.0, hbm_bw=1.0, ici_bw=1.0))
    assert rec["status"] == "ok" and rec["memory"]["fits_hbm"]
    shape = SHAPES["decode_32k"]
    want = 2.0 * rec["n_active_params"] * shape.global_batch
    assert rec["roofline"]["model_flops_per_device"] == want
    json.dumps(rec)
    assert "[dryrun] rwkv6-3b_decode_32k_1xH100:" in capsys.readouterr().out
    table = tmp_path / "roofline.md"
    roofline.main(["--dir", str(out), "--out", str(table)])
    assert "| rwkv6-3b | decode_32k |" in table.read_text()


def test_dryrun_honours_skip_shapes(tmp_path, capsys):
    arch = next(a for a in list_archs() if get_arch(a).skip_shapes)
    shape = next(iter(get_arch(arch).skip_shapes))
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(tmp_path)])
    assert f"[dryrun] SKIP {arch} x {shape}" in capsys.readouterr().out
    assert not list(tmp_path.glob("*.json"))


def test_hw_is_the_h100_datasheet():
    assert (HW.PEAK_BF16_FLOPS, HW.PEAK_TF32_FLOPS, HW.PEAK_F32_FLOPS,
            HW.HBM_BW, HW.HBM_BYTES) == (989e12, 495e12, 67e12, 3.35e12,
                                         80e9)
    assert work.bound_ms(67e9, 0.0) == (1.0, "operations")
    assert work.bound_ms(0.0, 3.35e9) == (1.0, "bytes")
