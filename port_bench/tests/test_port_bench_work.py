"""The frozen kernel formulas and peaks against the program's copies."""
from __future__ import annotations

import pytest

from port_bench import work

SHAPES = [(8, 8, 24, 32, 4), (8, 4, 16, 16, 4), (1, 64, 24, 96, 4)]


def test_peaks_match():
    from repro_torch.launch.mesh import HW
    assert work.PEAK_F32_FLOPS == HW.PEAK_F32_FLOPS
    assert work.PEAK_TF32_FLOPS == HW.PEAK_TF32_FLOPS
    assert work.HBM_BW == HW.HBM_BW


@pytest.mark.parametrize("shape", SHAPES)
def test_gru_flops_match(shape):
    from repro_torch.kernels import work as pw
    assert work.gru_flops(*shape) == pw.gru_flops(*shape)
    f = work.gru_flops(*shape)
    assert work.bound_ms(f, 0.0) == pytest.approx(pw.bound_ms(f, 0.0)[0])


@pytest.mark.parametrize("shape", [(64, 24, 3, 35, 3), (128, 1000, 3, 35, 3),
                                   (160, 24, 3, 35, 3)])
def test_rk4_flops_match(shape):
    from repro_torch.kernels import work as pw
    assert work.rk4_flops(*shape) == pw.rk4_flops(*shape)


def test_tick_flops_from_the_cells_shapes():
    from port_bench import run
    cfg = run.load_cell("f8-twin64.damage").cfg
    gru = work.gru_flops(8, 8, 24, 32, 4)
    head = 2.0 * 64 * (64 * 32 + 32 * (3 * 35 + 1))
    rk4 = work.rk4_flops(64, 24, 3, 35, 3)
    coll = 2.0 * 64 * 23 * 3 * 35
    step = 3 * (gru + head + rk4 + coll)
    guard = work.rk4_flops(64, 32, 3, 35, 3)
    assert work.tick_flops(cfg, 0) == pytest.approx(2 * step + guard)
    promote = gru + head + 2 * work.rk4_flops(8, 32, 3, 35, 3)
    assert work.tick_flops(cfg, 1) == pytest.approx(2 * step + guard
                                                    + promote)
    fleet = run.load_cell("f8-fleet10k.steady").cfg
    assert work.guard_flops(fleet) == work.rk4_flops(160, 24, 3, 35, 3)
