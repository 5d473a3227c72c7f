"""`correct` comes out false when the timed path is broken underneath,
once for each fault the cells can have, and for the control: the plain
reference in TF32 in the program's place.  The runs skip the look for a
card and drive the rest of a run on the CPU at a small size."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import check, run
from port_bench.tests.conftest import args, small_cell

SEED = 3_000_000_077


def _run(name, cpu):
    result, session = run.execute(small_cell(name), args(SEED, 2.0), cpu)
    return result, session


def _fails(result):
    return not result["correct"]


@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.steady"])
def test_a_step_that_returns_its_state_unchanged(name, cpu, monkeypatch):
    from repro_torch.core.fleet import FleetMerinda
    real = FleetMerinda.train_step_per_slot

    def stale(self, state, y_win, u_win):
        _, loss, ok = real(self, state, y_win, u_win)
        return state, loss, ok
    monkeypatch.setattr(FleetMerinda, "train_step_per_slot", stale)
    result, _ = _run(name, cpu)
    assert _fails(result)
    assert result["checks"]["refit_step_rel"]["value"] >= 0.99


@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.steady"])
def test_half_of_the_batch_left_out(name, cpu, monkeypatch):
    from repro_torch.core.merinda import Merinda
    real = Merinda.loss

    def half(self, params, batch, sparsify_enable=False):
        y, u = batch
        B = y.shape[-3] // 2
        return real(self, params, (y[..., :B, :, :], u[..., :B, :, :]),
                    sparsify_enable)
    monkeypatch.setattr(Merinda, "loss", half)
    result, _ = _run(name, cpu)
    assert _fails(result)
    assert (result["checks"]["refit_loss_rel"]["value"]
            > result["checks"]["refit_loss_rel"]["limit"])


@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.steady"])
def test_a_guard_score_altered_where_it_is_produced(name, cpu, monkeypatch):
    from repro_torch.twin.monitor import DivergenceGuard
    real = DivergenceGuard.score

    def altered(self, theta, ys, us):
        out = real(self, theta, ys, us).clone()
        out[0] *= 1.1
        return out
    monkeypatch.setattr(DivergenceGuard, "score", altered)
    result, _ = _run(name, cpu)
    assert _fails(result)
    assert (result["checks"]["guard_score_rel"]["value"]
            > result["checks"]["guard_score_rel"]["limit"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _moments_zeroed(real):
    """Every tick's refit starts from zero moments; step counts kept."""
    def refit(self, *a, **k):
        opt = self._fstate["opt"]
        for leaf in _leaves(opt.mu) + _leaves(opt.nu):
            leaf.zero_()
        return real(self, *a, **k)
    return refit


def _params_dropped(real):
    """The tick's new parameters are dropped once its refit has run."""
    def refit(self, *a, **k):
        before = [p.clone() for p in _leaves(self._fstate["params"])]
        out = real(self, *a, **k)
        for p, b in zip(_leaves(self._fstate["params"]), before):
            p.copy_(b)
        return out
    return refit


@pytest.mark.parametrize("fault", [_moments_zeroed, _params_dropped])
@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.steady"])
def test_state_not_carried_from_one_tick_to_the_next(name, fault, cpu,
                                                     monkeypatch):
    from repro_torch.twin.server import TwinServer
    monkeypatch.setattr(TwinServer, "_refit", fault(TwinServer._refit))
    result, _ = _run(name, cpu)
    assert _fails(result)
    assert result["checks"]["chain_mismatch"]["value"] > 0


@pytest.mark.parametrize("entry", ["train_step_per_slot", "score"])
@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.whatif"])
def test_a_route_past_the_observed_entry_is_not_correct(name, entry, cpu,
                                                        monkeypatch):
    """A refit or guard that no longer goes through the entry the check
    observes (renamed, fused, captured in a graph) reads nothing there."""
    real = check.Recorder._wrap

    def wrap(obj, attr, make):
        if attr != entry:
            real(obj, attr, make)
    monkeypatch.setattr(check.Recorder, "_wrap", staticmethod(wrap))
    result, _ = _run(name, cpu)
    assert _fails(result)
    assert result["checks"]["unread"]["value"] > 0


def test_a_what_if_answer_altered_where_it_is_produced(cpu, monkeypatch):
    from repro_torch.twin.scenario import ScenarioRunner
    real = ScenarioRunner.rollout

    def altered(self, theta_hist, count, y0, us):
        center, lo, hi, conf = real(self, theta_hist, count, y0, us)
        center = center.copy()
        center[0, -1] += 1e-3 * np.abs(center).max()
        return center, lo, hi, conf
    monkeypatch.setattr(ScenarioRunner, "rollout", altered)
    result, _ = _run("f8-fleet10k.whatif", cpu)
    assert _fails(result)
    assert (result["checks"]["scenario_center_rel"]["value"]
            > result["checks"]["scenario_center_rel"]["limit"])


@pytest.mark.parametrize("name", ["f8-twin64.damage", "f8-fleet10k.whatif"])
def test_the_control_fails_a_limit(name, cpu):
    cell = small_cell(name)
    result, session = run.execute(cell, args(SEED + 1, 2.0), cpu)
    assert result["correct"]
    ctl, _ = check.evaluate(session.recorder, session.queries, session.tele,
                            cell.cfg, cpu, control=True)
    over = [k for k, v in ctl.items()
            if v > cell.limits["limits"].get(k, 0.0)]
    assert over, ctl


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from port_bench.reference import tf32_round
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -20,
                      1.0 + 2 ** -12], dtype=torch.float32)
    assert tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0]


def test_skipped_slot_steps_do_not_hide_the_live_ones():
    """Most of a shard's slot-steps skipped (zeroes on both sides) and the
    few live ones wrong: the refit numbers read the live ones."""
    rd = check.Readings()
    check._pooled(rd, [{"live": False, "loss": 0.0, "grad": 0.0,
                        "step": 0.0}] * 55
                  + [{"live": True, "loss": 0.5, "grad": 1.0,
                      "step": 1.0}] * 9)
    assert rd.v == {"refit_loss_rel": 0.5, "refit_grad_rel": 1.0,
                    "refit_step_rel": 1.0}
    rd = check.Readings()
    check._pooled(rd, [{"live": False, "loss": 0.0}] * 4)
    assert rd.v == {"refit_loss_rel": 0.0}
