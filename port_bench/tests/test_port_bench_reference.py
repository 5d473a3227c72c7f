"""The plain reference against the port on the CPU (where the port runs
its plain versions), call by call and over a few ticks of a small fleet."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import check, reference as ref, run
from port_bench.tests.conftest import args, small_cell

MER = dict(n=3, m=1, order=3, dt=0.01, hidden=16, head_hidden=16,
           n_active=24)


def _fleet_and_windows(F=3, N=4, k=16):
    from repro_torch.core.fleet import FleetConfig, FleetMerinda
    from repro_torch.core.merinda import MerindaConfig
    fleet = FleetMerinda(FleetConfig(MerindaConfig(**MER), fleet=F,
                                     windows_per_twin=N, sparsify_after=2),
                         device="cpu")
    state = fleet.init(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    from port_bench import telemetry
    ys, us = telemetry._simulate(gen, F * N, k, y0_scale=0.5,
                                 input_scale=0.03, noise_std=0.002,
                                 substeps=1, waves=[], device="cpu")
    y = ys.reshape(F, N, k + 1, 3)
    u = us.reshape(F, N, k, 1)
    for f in range(F):
        fleet.reset_slot(state, f, None, y[f], u[f],
                         generator=torch.Generator().manual_seed(10 + f))
    return fleet, state, y, u


def _ref_state(state):
    st = check.clone_tree(state)
    keys = check._leaf_keys(st["params"])
    return {"params": st["params"], "opt_step": st["opt"]["step"],
            "steps": st["steps"],
            "mu": {gk: st["opt"]["mu"][gk[0]][gk[1]] for gk in keys},
            "nu": {gk: st["opt"]["nu"][gk[0]][gk[1]] for gk in keys}}, keys


def test_steps_and_recovery_match_the_port():
    fleet, state, y, u = _fleet_and_windows()
    model = ref.Refit(dict(MER, lr=fleet.cfg.lr), "cpu")
    for step in range(4):                 # the mask switches on at step 3
        rs, keys = _ref_state(state)
        loss_r, grads_r, p_r, mu_r, nu_r = model.step(rs, y, u, 2)
        state, loss, ok = fleet.train_step_per_slot(state, y, u)
        assert bool(ok.all())
        torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-7)
        for gk in keys:
            torch.testing.assert_close(state["params"][gk[0]][gk[1]],
                                       p_r[gk], rtol=1e-4, atol=1e-6)
            torch.testing.assert_close(state["opt"].mu[gk[0]][gk[1]],
                                       mu_r[gk], rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(fleet.recover_all(state, y, u),
                               model.recover(state["params"], y, u),
                               rtol=1e-4, atol=1e-6)
    norm = model.norm_stats(y[0], u[0])
    want = fleet.model.norm_stats(y[0], u[0])
    for k in norm:
        torch.testing.assert_close(norm[k], want[k], rtol=1e-6, atol=1e-7)


def test_guard_and_scenario_match_the_port():
    from repro_torch.core.library import make_library
    from repro_torch.twin.monitor import DivergenceGuard, GuardConfig
    from repro_torch.twin.scenario import ScenarioConfig, ScenarioRunner
    from port_bench import telemetry
    lib = make_library(3, 1, 3)
    terms = torch.as_tensor(ref.library_terms(3, 1, 3))
    ys, us = telemetry._simulate(torch.Generator().manual_seed(8), 5, 24,
                                 y0_scale=1.0, input_scale=0.05,
                                 noise_std=0.002, substeps=1, waves=[],
                                 device="cpu")
    theta = torch.as_tensor(ref.f8_theta(3, 0.6), dtype=torch.float32)
    theta = theta.expand(5, 3, 35).clone()
    theta[1, 0, 3] += 0.1
    want = DivergenceGuard(lib, 0.01, GuardConfig(window=24)).score(
        theta, ys, us)
    torch.testing.assert_close(ref.guard_score(theta, ys, us, 0.01, terms),
                               want, rtol=1e-5, atol=1e-9)
    hist = theta[:4]
    runner = ScenarioRunner(lib, 0.01, ScenarioConfig())
    u_q = np.zeros((3, 50, 1), np.float32)
    u_q[:, 20:] = [[[0.01]], [[-0.02]], [[0.04]]]
    for count in (1, 3, 6):
        got = runner.rollout(hist, count, ys[0, -1], u_q)
        want = ref.scenario(hist, count, ys[0, -1], torch.as_tensor(u_q),
                            0.01, terms)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.whatif"])
def test_a_small_run_is_correct(name, cpu):
    cell = small_cell(name)
    result, session = run.execute(cell, args(2 ** 31 + 101, 2.0), cpu)
    assert result["correct"], result["checks"]
    assert session.recorder.records
    assert result["checks"]["exact_mismatch"]["value"] == 0
    assert "refit_loss_rel" in result["checks"]
