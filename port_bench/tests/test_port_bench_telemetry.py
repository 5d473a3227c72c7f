"""The frozen F-8 generator against the program's systems at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import reference as ref, telemetry


def test_nominal_draws_match_the_program():
    from repro_torch.systems.f8_crusader import F8Crusader
    from repro_torch.systems.simulate import simulate_batch
    tr = simulate_batch(F8Crusader(), torch.Generator().manual_seed(5), 6,
                        horizon=60, noise_std=0.002, device="cpu")
    ys, us = telemetry._simulate(torch.Generator().manual_seed(5), 6, 60,
                                 y0_scale=1.0, input_scale=0.05,
                                 noise_std=0.002, substeps=10, waves=[],
                                 device="cpu")
    torch.testing.assert_close(us, tr.us, rtol=0, atol=0)
    torch.testing.assert_close(ys, tr.ys_noisy, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("eff", [1.0, 0.25])
def test_coefficients_match_the_program(eff):
    from repro_torch.core.library import make_library
    from repro_torch.systems.f8_crusader import F8Crusader
    lib = make_library(3, 1, 3)
    want = F8Crusader().true_theta(lib)
    inputs = np.asarray(["u0" in nm for nm in lib.names])
    want[:, inputs] *= eff
    np.testing.assert_array_equal(ref.f8_theta(3, eff), want)
    assert ref.library_names(3, 1, 3) == list(lib.names)
    np.testing.assert_array_equal(ref.library_terms(3, 1, 3),
                                  lib.term_indices)


def test_damage_switches_at_its_sample_and_continues():
    traffic = {"history": 16, "chunk": 8, "y0_scale": 0.5,
               "input_scale": 0.03, "noise_std": 0.0, "substeps": 1,
               "damage": {"first_tick": 1, "every": 2, "per_wave": 2,
                          "effectiveness": 0.25}}
    ys, us = telemetry.fleet(2 ** 31 + 3, 4, 64, traffic, "cpu")
    nominal = dict(traffic, damage=None)
    ys0, us0 = telemetry.fleet(2 ** 31 + 3, 4, 64, nominal, "cpu")
    np.testing.assert_array_equal(us, us0)
    at = 16 + 8                          # tick 1's first sample
    np.testing.assert_array_equal(ys[:, :at + 1], ys0[:, :at + 1])
    assert not np.array_equal(ys[:2, at + 1:], ys0[:2, at + 1:])
    np.testing.assert_array_equal(ys[2:, :at + 17], ys0[2:, :at + 17])
    assert not np.array_equal(ys[2:, at + 17:], ys0[2:, at + 17:])


def test_same_seed_same_samples_and_traces_stay_in_flight():
    traffic = {"history": 8, "chunk": 8, "y0_scale": 1.0,
               "input_scale": 0.05, "noise_std": 0.002, "substeps": 1,
               "damage": None}
    a = telemetry.fleet(3_000_000_019, 64, 400, traffic, "cpu")
    b = telemetry.fleet(3_000_000_019, 64, 400, traffic, "cpu")
    c = telemetry.fleet(3_000_000_020, 64, 400, traffic, "cpu")
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])
    assert np.isfinite(a[0]).all()
    assert np.abs(a[0]).max() <= telemetry.MAX_STATE
