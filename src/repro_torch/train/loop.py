"""Generic fault-tolerant training loop.

The JAX package's train/loop.py: a train step, a data iterator, async
checkpointing (train/checkpoint.py), heartbeat and straggler monitors,
failure injection (tests) and resume from the newest checkpoint.  Used by
launch/train.py and the tests.

Two differences, both of the port's own making:
  * a step's time `dt_s` ends in a synchronize of the metrics' device (JAX
    blocks on the metrics), so on the card it is the step's device time
    and not its enqueue;
  * a step that raises (a `SimulatedPreemption` included) first joins the
    pending checkpoint writer.  In the JAX loop a straggler's forced save
    and the regular save can write one step twice; a preemption then
    leaves the second writer running, and a restart reads the directory
    while it is being replaced (a leaf file missing).  Every save JAX makes
    is still made, in the same order.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Heartbeat,
                                                     StragglerDetector)
from repro_torch.train.checkpoint import CheckpointManager, tree_flatten

__all__ = ["LoopConfig", "run_loop"]


@dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    straggler_threshold: float = 3.0
    injector: FailureInjector | None = None
    log_fn: Callable[[str], None] = print
    metrics_hook: Callable[[int, dict], None] | None = None


def _device(tree) -> torch.device:
    """The device of the tree's first tensor (the CPU without one)."""
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _sync(metrics: dict) -> None:
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)


def run_loop(train_step: Callable, state: Any, data: Iterator,
             cfg: LoopConfig) -> tuple[Any, list[dict]]:
    """Runs to cfg.total_steps, resuming from the latest checkpoint if one
    exists (restored onto the device of `state`).  Returns (final state,
    metrics history)."""
    mgr = (CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep,
                             save_every=cfg.ckpt_every)
           if cfg.ckpt_dir else None)
    hb = Heartbeat()
    straggler = StragglerDetector(threshold=cfg.straggler_threshold)
    history: list[dict] = []

    start = 0
    if mgr is not None:
        step0, restored = mgr.restore_latest(state, device=_device(state))
        if restored is not None:
            state = restored
            start = int(step0)
            cfg.log_fn(f"[loop] resumed from checkpoint step {start}")

    try:
        for step in range(start, cfg.total_steps):
            if cfg.injector is not None:
                cfg.injector.maybe_fail(step)
            batch = next(data)
            t0 = time.monotonic()
            state, metrics = train_step(state, batch)
            _sync(metrics)
            dt = time.monotonic() - t0
            hb.beat(step)
            if straggler.observe(step, dt):
                cfg.log_fn(f"[loop] straggler at step {step}: {dt:.2f}s "
                           f"(ewma {straggler.ewma_s:.2f}s) — early "
                           "checkpoint")
                if mgr is not None:
                    mgr.maybe_save(step + 1, state, force=True)
            m = {k: float(v) for k, v in metrics.items()
                 if getattr(v, "ndim", 0) == 0}
            m["step"], m["dt_s"] = step, dt
            history.append(m)
            if cfg.metrics_hook:
                cfg.metrics_hook(step, m)
            if step % cfg.log_every == 0:
                loss = m.get("loss", m.get("nll", float("nan")))
                cfg.log_fn(f"[loop] step {step}: loss {loss:.4f} "
                           f"({dt:.2f}s)")
            if mgr is not None:
                mgr.maybe_save(step + 1, state)
        if mgr is not None:
            mgr.maybe_save(cfg.total_steps, state, force=True)
    finally:
        if mgr is not None:
            mgr.wait()
    return state, history
