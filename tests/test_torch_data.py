"""Host threads of the data pipeline, and three JAX signatures the port
lacked.

Mirrors tests/test_data.py's prefetch tests (order and completion, a
straggler counted) and covers `BackgroundPump`, the serving tick's
background flush: every kicked batch delivered in order, a producer error
surfaced on the consumer, `idle()` as the drain barrier, backpressure at
the queue depth.  Then the API gaps, each against the JAX call on the same
inputs: `WindowDataset.from_trace(normalize=)` (accepted and ignored, as
in JAX), `MerindaConfig.with_` and `PolyLibrary.term_name`.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.library import make_library as jax_make_library
from repro.core.merinda import MerindaConfig as JaxMerindaConfig
from repro.data.pipeline import WindowDataset as JaxWindowDataset
from repro_torch.core.library import make_library
from repro_torch.core.merinda import MerindaConfig
from repro_torch.data.pipeline import (BackgroundPump, PrefetchIterator,
                                       WindowDataset)


def test_prefetch_iterator_order_and_completion():
    it = PrefetchIterator(iter(range(10)), depth=2)
    assert list(it) == list(range(10))


def test_prefetch_straggler_counted():
    def slow_gen():
        yield 1
        time.sleep(0.3)
        yield 2

    it = PrefetchIterator(slow_gen(), depth=1, deadline_s=0.05)
    out = list(it)
    assert out == [1, 2]
    assert it.straggler_events >= 1


def _wait_idle(pump, timeout=5.0):
    t0 = time.monotonic()
    while not pump.idle():
        assert time.monotonic() - t0 < timeout, "pump never went idle"
        time.sleep(1e-3)


def test_background_pump_delivers_every_batch_in_order():
    """A swap-based producer behind the pump: items staged by several
    threads come out once each, in staging order per thread, and
    nothing is left once the pump is idle and drained."""
    lock = threading.Lock()
    staged: list = []

    def produce():
        with lock:
            out = list(staged)
            staged.clear()
        return out or None

    pump = BackgroundPump(produce, depth=2)
    got: list = []

    def sensor(k):
        for i in range(200):
            with lock:
                staged.append((k, i))
            pump.kick()

    threads = [threading.Thread(target=sensor, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            for batch in pump.drain():
                got.extend(batch)
            time.sleep(1e-3)
        while not pump.idle() or pump.queue_depth():
            for batch in pump.drain():
                got.extend(batch)
            time.sleep(1e-3)
        for batch in pump.drain():
            got.extend(batch)
    finally:
        pump.close()
    assert sorted(got) == [(k, i) for k in range(4) for i in range(200)]
    for k in range(4):
        assert [i for kk, i in got if kk == k] == list(range(200))


def test_background_pump_surfaces_producer_errors():
    calls = []

    def produce():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("produce failed")
        return len(calls)

    pump = BackgroundPump(produce, depth=4)
    try:
        pump.kick()
        _wait_idle(pump)
        assert pump.drain() == [1]
        pump.kick()
        _wait_idle(pump)          # a dead produce() still serves its kick
        with pytest.raises(RuntimeError, match="produce failed"):
            pump.drain()
        pump.kick()
        _wait_idle(pump)
        assert pump.drain() == [3]   # the worker lives on
    finally:
        pump.close()


def test_background_pump_backpressure_at_depth():
    """With the queue full the worker blocks; the gauge reads the depth."""
    n = iter(range(100))
    pump = BackgroundPump(lambda: next(n), depth=2)
    try:
        for depth in (1, 2):
            pump.kick()
            t0 = time.monotonic()
            while pump.queue_depth() < depth:
                assert time.monotonic() - t0 < 5.0
                time.sleep(1e-3)
        pump.kick()
        time.sleep(0.05)
        assert pump.queue_depth() == 2
        assert not pump.idle()       # the third batch waits for room
        assert pump.drain() == [0, 1]
        _wait_idle(pump)
        assert pump.drain() == [2]
    finally:
        pump.close()


# --------------------------------------------------------------------------- #
# the three API gaps
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("normalize", [False, True])
def test_window_dataset_from_trace_accepts_normalize(normalize):
    rng = np.random.default_rng(3)
    ys = rng.normal(size=(2, 41, 3)).astype(np.float32)
    us = rng.normal(size=(2, 40, 1)).astype(np.float32)
    jds = JaxWindowDataset.from_trace(jnp.asarray(ys), jnp.asarray(us), 0.01,
                                      window=8, stride=4,
                                      normalize=normalize)
    tds = WindowDataset.from_trace(torch.from_numpy(ys),
                                   torch.from_numpy(us), 0.01, window=8,
                                   stride=4, normalize=normalize)
    np.testing.assert_array_equal(tds.y_win.numpy(), np.asarray(jds.y_win))
    np.testing.assert_array_equal(tds.u_win.numpy(), np.asarray(jds.u_win))
    assert tds.dt == jds.dt


def test_merinda_config_with_matches_jax():
    kw = dict(n=3, m=1, order=3, hidden=32)
    changes = dict(hidden=96, n_active=12, l1=5e-4)
    jcfg = JaxMerindaConfig(**kw).with_(**changes)
    tcfg = MerindaConfig(**kw).with_(**changes)
    for f in ("n", "m", "order", "hidden", "head_hidden", "n_active", "dt",
              "l1", "theta_scale", "collocation_weight", "learn_shift"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert MerindaConfig(**kw).hidden == 32       # a copy, not a mutation


@pytest.mark.parametrize("n,m,order", [(3, 1, 3), (2, 0, 2), (4, 2, 2)])
def test_poly_library_term_name_matches_jax(n, m, order):
    jlib, lib = jax_make_library(n, m, order), make_library(n, m, order)
    assert [lib.term_name(j) for j in range(lib.size)] == \
        [jlib.term_name(j) for j in range(jlib.size)]
