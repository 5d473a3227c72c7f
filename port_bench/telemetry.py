"""The benchmark's telemetry: F-8 Crusader fleets simulated from the seed.

Plain PyTorch, frozen with the benchmark so that a change to the program
cannot change its inputs.  One call makes every sample a run will feed:
initial states uniform over the F-8's trim neighbourhood (scaled by
`y0_scale`), a sum of four sines per airframe as the elevator input (random
frequency 0.1-1.5 Hz, phase and amplitude 0.2-1.0, summed in float64,
times `input_scale`), RK4 integration with the input held over each sample
(`substeps` RK4 steps a sample), then Gaussian noise of `noise_std` times
each trace's own standard deviation per channel.  Draws, in order: the
initial states, the inputs, the noise -- the order of the program's
`simulate_batch`, so a test can hold the two side by side.

Damage waves switch airframes to the damaged model at given samples,
continuing from their current state.  Traces that leave controlled flight
(non-finite, or an angle beyond `MAX_STATE`) are drawn again, whole, from
generators derived from the seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import f8_theta, library_terms, rk4

F8_Y0_LOW = (-0.15, -0.05, -0.05)
F8_Y0_HIGH = (0.30, 0.05, 0.05)
F8_DT = 0.01
MAX_STATE = 10.0       # rad or rad/s: a trace beyond it has left flight
REDRAWS = 10


def sum_of_sines(gen, horizon: int, batch: int, scale: float, device,
                 m: int = 1, n_tones: int = 4, dt: float = F8_DT):
    """Inputs [batch, horizon, m] (float32)."""
    shape = (batch, m, n_tones)
    kw = dict(generator=gen, dtype=torch.float64, device=device)
    freqs = 0.1 + 1.4 * torch.rand(shape, **kw)
    phases = 2 * math.pi * torch.rand(shape, **kw)
    amps = 0.2 + 0.8 * torch.rand(shape, **kw)
    t = (torch.arange(horizon, dtype=torch.float64, device=device)
         * dt).reshape(horizon, 1, 1, 1)
    us = (amps * torch.sin(2 * math.pi * freqs * t + phases)).sum(-1) * scale
    return us.to(torch.float32).movedim(0, 1)


def _simulate(gen, batch: int, samples: int, *, y0_scale: float,
              input_scale: float, noise_std: float, substeps: int,
              waves: list, device):
    """(noisy ys [batch, samples+1, 3], us [batch, samples, 1]); `waves`
    holds (sample, rows, effectiveness) switches."""
    lo = torch.tensor(F8_Y0_LOW) * y0_scale
    hi = torch.tensor(F8_Y0_HIGH) * y0_scale
    y0 = (lo.to(device) + (hi - lo).to(device)
          * torch.rand((batch, 3), generator=gen, device=device))
    us = sum_of_sines(gen, samples, batch, input_scale, device)
    terms = torch.as_tensor(library_terms(3, 1, 3), device=device)
    theta = torch.as_tensor(f8_theta(3), dtype=torch.float32,
                            device=device).expand(batch, 3, -1).clone()
    switch = {}
    for at, rows, eff in waves:
        switch.setdefault(at, []).append((rows, eff))
    h = F8_DT / substeps
    y = y0.clone()
    u = torch.empty((batch, substeps, 1), device=device)

    def step():
        y.copy_(rk4(theta, y, u, h, terms)[:, -1])
    advance = _graphed(step, y) if y.device.type == "cuda" else step
    ys = torch.empty((batch, samples + 1, 3), device=device)
    ys[:, 0] = y0
    for s in range(samples):
        for rows, eff in switch.get(s, ()):
            theta[rows] = torch.as_tensor(f8_theta(3, eff), dtype=theta.dtype,
                                          device=device)
        u.copy_(us[:, s:s + 1].expand(batch, substeps, 1))
        advance()
        ys[:, s + 1] = y
    noise = torch.randn(ys.shape, generator=gen, device=device)
    noisy = ys + noise_std * noise * ys.std(dim=1, keepdim=True,
                                            correction=0)
    return noisy, us


def _graphed(step, y):
    """`step` captured once in a CUDA graph (its tensors stay in place), so
    each sample costs one replay instead of some forty launches."""
    import torch.cuda as cuda
    keep = y.clone()
    side = cuda.Stream()
    side.wait_stream(cuda.current_stream())
    with cuda.stream(side):
        step()                              # first use outside the capture
    cuda.current_stream().wait_stream(side)
    y.copy_(keep)
    graph = cuda.CUDAGraph()
    with cuda.graph(graph):
        step()
    y.copy_(keep)
    return graph.replay


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for sub-stream `stream` of `seed`."""
    mixed = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return torch.Generator(device=device).manual_seed(
        int(mixed.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1))


def fleet(seed: int, twins: int, samples: int, traffic: dict, device):
    """Every sample of a run, on the host: ys [twins, samples+1, 3] and us
    [twins, samples, 1] float32 numpy arrays."""
    dmg = traffic.get("damage")
    waves = []
    if dmg:
        ids = list(range(twins))
        for w, start in enumerate(range(0, twins, dmg["per_wave"])):
            tick = dmg["first_tick"] + w * dmg["every"]
            at = traffic["history"] + tick * traffic["chunk"]
            if at < samples:
                waves.append((ids[start:start + dmg["per_wave"]], at,
                              dmg["effectiveness"]))
    kw = dict(y0_scale=traffic["y0_scale"],
              input_scale=traffic["input_scale"],
              noise_std=traffic["noise_std"], substeps=traffic["substeps"],
              device=device)
    ys, us = _simulate(generator(seed, 0, device), twins, samples,
                       waves=[(at, rows, eff) for rows, at, eff in waves],
                       **kw)
    for attempt in range(1, REDRAWS + 1):
        bad = torch.nonzero(~(torch.isfinite(ys).all(dim=(1, 2))
                              & (ys.abs().amax(dim=(1, 2)) <= MAX_STATE)))
        bad = bad[:, 0].tolist()
        if not bad:
            return ys.cpu().numpy(), us.cpu().numpy()
        index = {row: k for k, row in enumerate(bad)}
        sub = [([index[r] for r in rows if r in index], at, eff)
               for rows, at, eff in waves]
        ys_b, us_b = _simulate(generator(seed, attempt, device), len(bad),
                               samples, waves=[(at, rows, eff)
                                               for rows, at, eff in sub
                                               if rows], **kw)
        ys[bad], us[bad] = ys_b, us_b
    raise RuntimeError(f"telemetry: {len(bad)} traces still leave flight "
                       f"after {REDRAWS} redraws")
