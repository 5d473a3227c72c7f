"""End-to-end training entry point of the port.

  --merinda <system>: the paper's pipeline: train one MERINDA digital twin
    on simulated traces of a registered system (simulate_batch -> windows
    -> fit -> recover -> reconstruction MSE), on the card.
  --arch <id> [--smoke]: LM training on the synthetic token stream
    (data/tokens.py), AdamW with a cosine schedule, through the
    fault-tolerant loop (train/loop.py: checkpoints under --ckpt-dir,
    resume, --fail-at); --smoke takes the reduced config.  On the card
    every RWKV-6 and Mamba-2 layer's forward launches the linear-scan
    kernel (twice a step: the backward recomputes each layer).

    PYTHONPATH=src python -m repro_torch.launch.train --merinda f8_crusader \
        --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
        --steps 20 --batch 4 --seq-len 1024

The flags and their defaults are the JAX package's (repro.launch.train).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.merinda import Merinda, MerindaConfig
from repro_torch.core.trainer import fit
from repro_torch.data.pipeline import WindowDataset
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed.compression import topk_compressor
from repro_torch.distributed.fault_tolerance import FailureInjector
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.zoo import build
from repro_torch.systems.simulate import register_systems, simulate_batch
from repro_torch.train.loop import LoopConfig, run_loop
from repro_torch.train.optimizer import adamw, cosine_schedule, tree_leaves
from repro_torch.train.train_state import init_state, make_train_step

__all__ = ["train_lm", "train_merinda", "main"]


def _on(device, batches):
    """Numpy batches as tensors on `device`."""
    for batch in batches:
        yield {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train_lm(args, *, device=None):
    """LM training of `args.arch` (its SMOKE config under `args.smoke`)
    from random weights drawn from `args.seed`: AdamW (weight decay 0.1,
    clipping at 1.0) on a cosine schedule with 10 warm-up steps, the top-k
    compressor under `args.compress`, the synthetic token stream, and
    `run_loop` with checkpoints under `args.ckpt_dir`.  Prints the JAX
    package's two lines and returns (state, history).  `device=None` runs
    on the card and raises without one; the tests pass "cpu".  The step
    consumes its state (`donate=True`): one copy of the parameters and
    moments is held."""
    device = resolve_device(device)
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    api = build(cfg, max_position=args.seq_len)
    params = api.init(seed=args.seed, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}{' (smoke)' if args.smoke else ''}: "
          f"{n_params:,} params")

    opt = adamw(lr=cosine_schedule(args.lr, 10, args.steps), weight_decay=0.1)
    compressor = (topk_compressor(args.compress, group=api.stack_key)
                  if args.compress else None)
    step_fn = make_train_step(api.loss, opt, grad_accum=args.grad_accum,
                              compressor=compressor, donate=True)
    state = init_state(params, opt)
    if compressor is not None:
        state["comp"] = compressor.init(params)

    stream = TokenStream(vocab=cfg.vocab, batch=args.batch,
                         seq_len=args.seq_len, seed=args.seed,
                         d_frontend=cfg.d_model if api.is_encdec else None)
    injector = (FailureInjector(fail_at_step=args.fail_at)
                if args.fail_at is not None else None)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every, injector=injector)
    state, history = run_loop(step_fn, state, _on(device, stream), loop_cfg)
    print(f"[train] done: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f} over {len(history)} steps")
    return state, history


def train_merinda(args, *, device=None):
    """Train and recover one MERINDA twin of `args.merinda`; prints the
    reconstruction MSE and the recovered coefficients and returns
    (FitResult, theta, mse).  `device=None` runs on the card and raises
    without one; the tests pass "cpu"."""
    device = resolve_device(device)
    system = register_systems()[args.merinda]()
    gen = torch.Generator().manual_seed(args.seed)
    trace = simulate_batch(system, gen, batch=8, noise_std=0.01,
                           device=device)
    ds = WindowDataset.from_trace(trace.ys_noisy, trace.us, system.spec.dt,
                                  window=args.window)
    n_active = int((np.abs(system.true_theta()) > 0).sum())
    model = Merinda(MerindaConfig(n=system.spec.n, m=system.spec.m,
                                  order=system.spec.order, dt=system.spec.dt,
                                  hidden=args.hidden, n_active=n_active))
    params = model.init(gen, model.norm_stats(ds.y_win, ds.u_win),
                        device=device)
    result = fit(model, params,
                 ds.batches(gen, args.batch, epochs=10_000),
                 steps=args.steps, lr=args.lr, log_every=50)
    theta = model.recover(result.params, ds.y_win, ds.u_win)
    mse = float(model.reconstruction_mse(theta, ds.y_win, ds.u_win))
    print(f"[train] {args.merinda}: reconstruction MSE {mse:.4f}, "
          f"nan_restarts={result.nan_restarts}")
    print(model.lib.coeff_dict(theta))
    return result, theta, mse


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--merinda", default=None,
                    help="system id: " + "|".join(register_systems()))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", type=float, default=None,
                    help="top-k gradient compression keep fraction")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated preemption at this step")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.merinda:
        train_merinda(args)
    elif args.arch:
        train_lm(args)
    else:
        raise SystemExit("pass --arch or --merinda")


if __name__ == "__main__":
    main()
