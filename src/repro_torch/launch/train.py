"""End-to-end training entry point of the port.

  --merinda <system>: the paper's pipeline: train one MERINDA digital twin
    on simulated traces of a registered system (simulate_batch -> windows
    -> fit -> recover -> reconstruction MSE), on the card.
  --arch <id>: LM training is not ported yet (ROADMAP.md, Queue 1 item
    6); it raises NotImplementedError.

    PYTHONPATH=src python -m repro_torch.launch.train --merinda f8_crusader --steps 300

The flags and their defaults are the JAX package's (repro.launch.train);
those that only LM training reads are accepted and unused.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.merinda import Merinda, MerindaConfig
from repro_torch.core.trainer import fit
from repro_torch.data.pipeline import WindowDataset
from repro_torch.kernels.backend import resolve_device
from repro_torch.systems.simulate import register_systems, simulate_batch

__all__ = ["train_merinda", "main"]


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
        raise NotImplementedError("LM training (--arch) is not ported yet: "
                                  "ROADMAP.md, Queue 1 item 6")
    else:
        raise SystemExit("pass --arch or --merinda")


if __name__ == "__main__":
    main()
