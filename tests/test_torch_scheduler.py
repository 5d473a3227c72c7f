"""Planner equivalence in the port, and against the JAX package.

The port's packed planner (one device scoring pass + PriorityBuckets pops,
here on CPU tensors) promises BYTE-IDENTICAL admit/evict/release decisions
to its dict-sorting reference planner, and both promise the JAX package's
`RefitScheduler` decisions on the same records.  Mirrors
tests/test_scheduler_equivalence.py: a seeded random sweep, the plan
invariants the server's `_apply_plan` relies on, a released slot refilled
in the same plan, exact bucket-queue order, and a hypothesis search.

Fleet generation keeps every priority EXACTLY representable in float32
(device ranking) and float64 (host comparisons): min_samples a power of
two, weights in {0.5, 1, 2, 4}, divergence a multiple of 1/8, integer
samples.  So every comparison is exact, with no tolerance.
"""
import dataclasses
import random

import pytest

from repro.twin.scheduler import RefitScheduler as JaxRefitScheduler
from repro.twin.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro.twin.scheduler import TwinRecord as JaxTwinRecord
from repro_torch.obs import MetricRegistry
from repro_torch.twin.scheduler import (PackedRefitScheduler, PriorityBuckets,
                                        RefitScheduler, SchedulerConfig,
                                        SchedulerMetrics, TwinRecord)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:       # an image without hypothesis
    HAVE_HYPOTHESIS = False

MIN_SAMPLES = (1, 2, 4, 8, 16)
WEIGHTS = (0.5, 1.0, 2.0, 4.0)


def _random_case(rng):
    """One random (cfg kwargs, port records, max_active) problem."""
    slots = rng.randint(1, 6)
    cfg = dict(
        slots=slots,
        min_samples=rng.choice(MIN_SAMPLES),
        staleness_weight=rng.choice(WEIGHTS),
        divergence_weight=rng.choice(WEIGHTS),
        evict_margin=rng.choice([0.0, 0.5, 1.0]),
        min_residency=rng.choice([0, 1, 2, 4]),
        max_residency=rng.choice([2, 4, 8]),
        release_divergence=rng.choice([0.05, 0.25, 1.0]))
    n = rng.randint(0, 40)
    free_slots = list(range(slots))
    rng.shuffle(free_slots)
    twins = {}
    for tid in range(n):
        resident = bool(free_slots) and rng.random() < 0.3
        rec = TwinRecord(
            twin_id=tid, ring_slot=tid,
            refit_slot=free_slots.pop() if resident else None,
            samples=rng.randint(0, 48),
            deployed=rng.random() < 0.5,
            residency=rng.randint(0, 20) if resident else 0,
            divergence=rng.randint(0, 24) / 8)
        rec.samples_at_deploy = rng.randint(0, rec.samples)
        twins[tid] = rec
    max_active = rng.choice([None, rng.randint(0, slots)])
    return cfg, twins, max_active


def _jax_records(twins):
    return {t: JaxTwinRecord(**dataclasses.asdict(r))
            for t, r in twins.items()}


def _three_plans(cfg, twins, max_active):
    """(port reference, port packed, JAX reference) plans."""
    ref = RefitScheduler(SchedulerConfig(**cfg)).plan(twins,
                                                      max_active=max_active)
    got = PackedRefitScheduler(SchedulerConfig(**cfg),
                               device="cpu").plan_records(
        twins, max_active=max_active)
    jax = JaxRefitScheduler(JaxSchedulerConfig(**cfg)).plan(
        _jax_records(twins), max_active=max_active)
    return ref, got, jax


def _fields(plan):
    return plan.admit, plan.evict, plan.release


def test_random_fleets_plan_identically():
    rng = random.Random(1234)
    for _ in range(400):
        cfg, twins, max_active = _random_case(rng)
        ref, got, jax = _three_plans(cfg, twins, max_active)
        assert _fields(got) == _fields(ref) == _fields(jax)
        assert RefitScheduler(SchedulerConfig(**cfg)).pressure(twins) == \
            JaxRefitScheduler(JaxSchedulerConfig(**cfg)).pressure(
                _jax_records(twins))


def test_plans_obey_slot_invariants():
    """What `TwinServer._apply_plan` assumes: admitted slots are distinct,
    every admitted twin appears once, no admitted twin is simultaneously
    evicted/released, and evicted/released twins were residents."""
    rng = random.Random(99)
    for _ in range(200):
        cfg, twins, max_active = _random_case(rng)
        for planner in (RefitScheduler(SchedulerConfig(**cfg)).plan,
                        PackedRefitScheduler(SchedulerConfig(**cfg),
                                             device="cpu").plan_records):
            plan = planner(twins, max_active=max_active)
            slots_assigned = [s for s, _ in plan.admit]
            tids_admitted = [t for _, t in plan.admit]
            assert len(set(slots_assigned)) == len(slots_assigned)
            assert len(set(tids_admitted)) == len(tids_admitted)
            outgoing = set(plan.evict) | set(plan.release)
            assert not outgoing & set(tids_admitted)
            for tid in outgoing:
                assert twins[tid].refit_slot is not None
            for _, tid in plan.admit:
                assert twins[tid].refit_slot is None
            occupied = {r.refit_slot for r in twins.values()
                        if r.refit_slot is not None
                        and r.twin_id not in outgoing}
            for slot, _ in plan.admit:
                assert slot not in occupied
                occupied.add(slot)


def test_released_slot_is_readmittable_same_tick():
    """A converged resident's slot is handed to a waiting twin within the
    SAME plan, by both planners, with the metrics counting the turnover."""
    cfg = SchedulerConfig(slots=2, min_samples=10, min_residency=2,
                          max_residency=8)
    twins = {0: TwinRecord(twin_id=0, ring_slot=0, refit_slot=0, samples=50,
                           deployed=True, samples_at_deploy=50, residency=9,
                           divergence=0.01),
             1: TwinRecord(twin_id=1, ring_slot=1, samples=50),
             2: TwinRecord(twin_id=2, ring_slot=2, refit_slot=1, samples=50,
                           deployed=True, samples_at_deploy=50,
                           residency=4)}
    reg = MetricRegistry()
    metrics = SchedulerMetrics.create(reg, labels={"shard": "0"})
    for plan in (RefitScheduler(cfg, metrics=metrics).plan(twins),
                 PackedRefitScheduler(cfg, metrics=metrics,
                                      device="cpu").plan_records(twins)):
        assert plan.release == [0]
        assert plan.admit == [(0, 1)]      # the freed slot, refilled
    assert metrics.released.value == metrics.admitted.value == 2
    assert 'shard="0"' in reg.expose()


def test_priority_buckets_orders_exactly():
    """Pops come out in exact (-priority, key) order across buckets, with
    lazy deletion and reprioritization honored."""
    rng = random.Random(7)
    q = PriorityBuckets(quantum=0.25)
    live = {}
    for key in range(200):
        prio = rng.randint(0, 64) / 8
        q.push(key, prio)
        live[key] = prio
    for key in rng.sample(list(live), 60):       # lazy deletions
        q.discard(key)
        del live[key]
    for key in rng.sample(list(live), 40):       # reprioritizations
        live[key] = rng.randint(0, 64) / 8
        q.push(key, live[key])
    assert len(q) == len(live)
    expect = sorted(live.items(), key=lambda kv: (-kv[1], kv[0]))
    got = []
    while len(q):
        key, prio, _ = q.pop()
        got.append((key, prio))
    assert got == expect
    assert q.pop() is None and q.peek() is None


if HAVE_HYPOTHESIS:
    @st.composite
    def _cases(draw):
        seed = draw(st.integers(min_value=0, max_value=2**32 - 1))
        return _random_case(random.Random(seed))

    @pytest.mark.hypothesis
    @settings(deadline=None, max_examples=60)
    @given(_cases())
    def test_property_plans_identical(case):
        ref, got, jax = _three_plans(*case)
        assert _fields(got) == _fields(ref) == _fields(jax)
else:
    @pytest.mark.hypothesis
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_property_plans_identical():
        pass
