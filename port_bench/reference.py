"""The plain reference that `correct` is judged against.

Plain PyTorch in float32, written from the published equations: the F-8
Crusader polynomial model (Garrard & Jordan), the polynomial library
dY/dt = Theta Phi(Y, U), classic RK4 with a zero-order hold, a GRU
(z | r | c gates), MERINDA's encoder, dense head, magnitude sparsification,
RK4 decode and loss, AdamW with per-slot global-norm clipping, the guard's
normalized rollout score with its EMA and thresholds, and the what-if
ensemble rollout.  It imports nothing of the program under test: every
number it needs comes from the benchmark's own telemetry and from the
program state handed to it as plain tensors.

`tf32=True` rounds every operand of a product to TF32 (10 mantissa bits,
round to nearest) before the product: the control, the same arithmetic in
the nearest precision below the configuration's float32.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

# -- library ----------------------------------------------------------------- #


def library_terms(n: int, m: int, order: int) -> np.ndarray:
    """[L, order] indices into [1, Y, U]: every monomial of total degree <=
    order, lower degrees padded with index 0, by degree then in
    combinations-with-replacement order."""
    terms = []
    for d in range(order + 1):
        for combo in itertools.combinations_with_replacement(
                range(1, n + m + 1), d):
            terms.append(combo + (0,) * (order - d))
    return np.asarray(terms, np.int64)


def library_names(n: int, m: int, order: int) -> list[str]:
    def vname(k):
        return f"y{k - 1}" if k <= n else f"u{k - 1 - n}"
    return ["1" if not any(t) else
            "*".join(sorted(vname(k) for k in t if k))
            for t in library_terms(n, m, order).tolist()]


def f8_coefficients(effectiveness: float = 1.0) -> list[dict[str, float]]:
    """Garrard & Jordan's F-8 longitudinal model (y0 angle of attack, y1
    pitch angle, y2 pitch rate, u0 elevator); `effectiveness` scales every
    input-dependent coefficient (partial elevator loss)."""
    def nm(*p):
        return "*".join(sorted(p))
    a, b, q, u = "y0", "y1", "y2", "u0"
    rows = [
        {a: -0.877, q: 1.0, nm(a, q): -0.088, nm(a, a): 0.47,
         nm(b, b): -0.019, nm(a, a, q): -1.0, nm(a, a, a): 3.846,
         u: -0.215, nm(a, a, u): 0.28, nm(a, u, u): 0.47, nm(u, u, u): 0.63},
        {q: 1.0},
        {a: -4.208, q: -0.396, nm(a, a): -0.47, nm(a, a, a): -3.564,
         u: -20.967, nm(a, a, u): 6.265, nm(a, u, u): 46.0,
         nm(u, u, u): 61.4},
    ]
    return [{k: (v * effectiveness if "u" in k else v) for k, v in r.items()}
            for r in rows]


def f8_theta(order: int = 3, effectiveness: float = 1.0) -> np.ndarray:
    """The F-8 coefficients placed in the order-`order` library: [3, L]."""
    names = {s: j for j, s in enumerate(library_names(3, 1, order))}
    theta = np.zeros((3, len(names)), np.float64)
    for i, row in enumerate(f8_coefficients(effectiveness)):
        for term, c in row.items():
            theta[i, names[term]] = c
    return theta


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as float32,
    with the gradient of the identity."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach() if x.requires_grad else r


def _unbroadcast(g, shape):
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _TF32Product(torch.autograd.Function):
    """a @ b on TF32 operands, its backward products on TF32 operands too,
    as a TF32 matmul and its gradient run on the tensor cores."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return (_unbroadcast(g @ b.transpose(-1, -2), a.shape),
                _unbroadcast(a.transpose(-1, -2) @ g, b.shape))


def _mm(a, b, tf32: bool):
    return _TF32Product.apply(a, b) if tf32 else a @ b


def features(y, u, terms: torch.Tensor):
    """Phi(Y, U) [..., L] from y [..., n], u [..., m]."""
    aug = torch.cat([torch.ones_like(y[..., :1]), y, u], dim=-1)
    g = aug[..., terms]                                   # [..., L, order]
    phi = g[..., 0]
    for o in range(1, terms.shape[1]):
        phi = phi * g[..., o]
    return phi


def _contract(theta, phi, tf32: bool):
    """theta [..., n, L] . phi [..., L] -> [..., n]."""
    if tf32:
        theta, phi = tf32_round(theta), tf32_round(phi)
    return (theta * phi.unsqueeze(-2)).sum(-1)


def rk4(theta, y0, us, dt: float, terms, tf32: bool = False):
    """RK4 with inputs held over each step: theta [..., n, L], y0 [..., n],
    us [..., T, m] -> ys [..., T+1, n]."""
    def f(y, u):
        return _contract(theta, features(y, u, terms), tf32)
    y, out = y0, [y0]
    for t in range(us.shape[-2]):
        u = us[..., t, :]
        k1 = f(y, u)
        k2 = f(y + 0.5 * dt * k1, u)
        k3 = f(y + 0.5 * dt * k2, u)
        k4 = f(y + dt * k3, u)
        y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(y)
    return torch.stack(out, dim=-2)


# -- MERINDA refit step ------------------------------------------------------ #
class Refit:
    """One refit slot pool's model step in plain PyTorch.  `cfg` is the
    configuration's "merinda" group plus "lr"; parameters carry a leading
    slot axis [F, ...] with the groups gru {wx, wh, b}, head {w1, b1, w2,
    b2} and norm {mu, sigma, phi_scale}."""

    L1 = 1e-3              # sparsity penalty on the dense coefficients
    B1, B2, EPS = 0.9, 0.999, 1e-8
    CLIP = 1.0             # per-slot gradient norm

    def __init__(self, cfg: dict, device, tf32: bool = False):
        self.n, self.m, self.order = cfg["n"], cfg["m"], cfg["order"]
        self.hidden, self.k = cfg["hidden"], cfg["n_active"]
        self.dt, self.lr = cfg["dt"], cfg["lr"]
        self.terms = torch.as_tensor(library_terms(self.n, self.m,
                                                   self.order), device=device)
        self.L = self.terms.shape[0]
        self.tf32 = tf32

    def gru(self, xs, wx, wh, b):
        """xs [F, B, T, D] with per-slot weights -> (hs [F, B, T, H], hT)."""
        H = self.hidden
        h = xs.new_zeros(xs.shape[:2] + (H,))
        xp = _mm(xs, wx.unsqueeze(1), self.tf32) + b[:, None, None, :]
        hs = []
        for t in range(xs.shape[2]):
            x = xp[:, :, t]
            hz = _mm(h, wh[..., :2 * H], self.tf32)
            z = torch.sigmoid(x[..., :H] + hz[..., :H])
            r = torch.sigmoid(x[..., H:2 * H] + hz[..., H:])
            c = torch.tanh(x[..., 2 * H:] + _mm(r * h, wh[..., 2 * H:],
                                                self.tf32))
            h = (1 - z) * h + z * c
            hs.append(h)
        return torch.stack(hs, dim=2), h

    def encode(self, p, y_win, u_win):
        """Dense coefficients [F, B, n, L] and input shift [F, B, m]."""
        n, L = self.n, self.L
        norm = {k: v.detach() for k, v in p["norm"].items()}
        xs = torch.cat([y_win[..., :-1, :], u_win], dim=-1)
        xs = (xs - norm["mu"][:, None, None]) / norm["sigma"][:, None, None]
        g, hd = p["gru"], p["head"]
        hs, hT = self.gru(xs, g["wx"], g["wh"], g["b"])
        summary = torch.cat([hT, hs.mean(dim=2)], dim=-1)
        h = torch.relu(_mm(summary, hd["w1"], self.tf32) + hd["b1"][:, None])
        raw = _mm(h, hd["w2"], self.tf32) + hd["b2"][:, None]
        dense = raw[..., :n * L].unflatten(-1, (n, L)) \
            / norm["phi_scale"][:, None, None, :]
        return dense, raw[..., n * L:]

    def sparsify(self, dense, phi_scale, enable):
        """Keep the k largest |coefficient x column scale| per model (ties
        at the k-th kept), straight-through; `enable` [F] bool."""
        n, L = dense.shape[-2:]
        flat = dense.flatten(-2)
        mag = (flat * phi_scale.repeat(1, n)[:, None]).abs().detach()
        kth = torch.topk(mag, min(self.k, n * L), dim=-1).values[..., -1:]
        sparse = (flat * (mag >= kth).to(flat.dtype)).unflatten(-1, (n, L))
        return torch.where(enable[:, None, None, None], sparse, dense)

    @torch.no_grad()
    def mask_margin(self, params, y_win, u_win, enable):
        """Per slot [F], how clear the sparsify mask of a step is: over the
        slot's windows, the least gap between the k-th and the (k+1)-th
        largest |coefficient x column scale|, relative to the k-th (inf
        where the mask is off)."""
        dense, _ = self.encode(params, y_win, u_win)
        n = dense.shape[-2]
        phi_scale = params["norm"]["phi_scale"]
        mag = (dense.flatten(-2) * phi_scale.repeat(1, n)[:, None]).abs()
        top = torch.topk(mag, min(self.k + 1, mag.shape[-1]), dim=-1).values
        gap = (top[..., -2] - top[..., -1]) / top[..., -2].clamp(min=1e-30)
        return torch.where(enable, gap.amin(dim=1),
                           torch.full_like(gap[:, 0], float("inf")))

    def loss(self, p, y_win, u_win, enable):
        """Per-slot loss [F]: trajectory MSE + L1 + collocation."""
        dense, shift = self.encode(p, y_win, u_win)
        phi_scale = p["norm"]["phi_scale"].detach()
        theta = self.sparsify(dense, phi_scale, enable)
        y_est = rk4(theta, y_win[..., 0, :], u_win + shift[:, :, None],
                    self.dt, self.terms, self.tf32)
        dims = (1, 2, 3)
        ode = torch.square(y_est - y_win).mean(dim=dims)
        scaled = dense * phi_scale[:, None, None, :]
        l1 = torch.where(scaled >= 0, scaled, -scaled).mean(dim=dims)
        l1_w = torch.where(enable, 0.1 * self.L1, self.L1)
        dy = (y_win[..., 2:, :] - y_win[..., :-2, :]) / (2 * self.dt)
        phi = features(y_win[..., 1:-1, :], u_win[..., 1:, :], self.terms)
        pred = _contract(theta.unsqueeze(2), phi, self.tf32)
        coll = torch.square(pred - dy).mean(dim=dims)
        return ode + l1_w * l1 + coll

    def step(self, state, y_win, u_win, sparsify_after: int):
        """One step from `state` {params, mu, nu, opt_step, steps}: returns
        (loss [F], clipped gradients, new params, new mu, new nu)."""
        p = {g: {k: v.detach().clone().requires_grad_(True)
                 for k, v in leaves.items()}
             for g, leaves in state["params"].items()}
        enable = state["steps"] > sparsify_after
        with torch.enable_grad():
            loss = self.loss(p, y_win, u_win, enable)
            keys = [(g, k) for g in p for k in p[g]]
            grads = torch.autograd.grad(loss.sum(), [p[g][k] for g, k in keys],
                                        allow_unused=True)
        F = loss.shape[0]
        grads = {gk: (torch.zeros_like(p[gk[0]][gk[1]]) if g is None else g)
                 for gk, g in zip(keys, grads)}
        sq = sum(g.reshape(F, -1).square().sum(1) for g in grads.values())
        scale = torch.clamp(self.CLIP / (sq.sqrt() + 1e-9), max=1.0)
        ok = torch.isfinite(loss)
        for gk in keys:
            g = grads[gk] * scale.reshape((F,) + (1,) * (grads[gk].ndim - 1))
            ok = ok & torch.isfinite(g).reshape(F, -1).all(1)
            grads[gk] = g
        t = (state["opt_step"] + 1).to(torch.float32)
        bc1, bc2 = 1 - self.B1 ** t, 1 - self.B2 ** t
        new_p, new_mu, new_nu = {}, {}, {}
        for gk in keys:
            g = grads[gk]
            g = torch.where(ok.reshape((F,) + (1,) * (g.ndim - 1)), g,
                            torch.zeros_like(g))
            grads[gk] = g
            mu = self.B1 * state["mu"][gk] + (1 - self.B1) * g
            nu = self.B2 * state["nu"][gk] + (1 - self.B2) * g.square()
            upd = -self.lr * (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            new_p[gk] = state["params"][gk[0]][gk[1]] + upd
            new_mu[gk], new_nu[gk] = mu, nu
        loss = torch.where(ok, loss.detach(), torch.zeros_like(loss))
        return loss, grads, new_p, new_mu, new_nu

    @torch.no_grad()
    def recover(self, params, y_win, u_win, margins: bool = False):
        """One sparse model per slot from all its windows: the median (mean
        of the two middle values) of the dense coefficients over windows,
        re-sparsified.  [F, n, L]; with `margins`, also the pooled dense
        coefficients and each one's distance from the selection threshold
        relative to it."""
        dense, _ = self.encode(params, y_win, u_win)
        s = torch.sort(dense, dim=1).values
        N = dense.shape[1]
        pooled = (s[:, (N - 1) // 2] + s[:, N // 2]) * 0.5
        enable = torch.ones(pooled.shape[0], dtype=torch.bool,
                            device=pooled.device)
        phi_scale = params["norm"]["phi_scale"]
        theta = self.sparsify(pooled[:, None], phi_scale, enable)[:, 0]
        if not margins:
            return theta
        n = pooled.shape[1]
        mag = (pooled.flatten(1) * phi_scale.repeat(1, n)).abs()
        kth = torch.topk(mag, min(self.k, mag.shape[1]), dim=1).values[:, -1:]
        margin = (mag - kth).abs() / kth.clamp(min=1e-30)
        return theta, pooled, margin.unflatten(1, pooled.shape[1:])

    @torch.no_grad()
    def norm_stats(self, y_win, u_win):
        """Per-channel mean and population std (+1e-6) of [Y ; U] over a
        slot's windows and time, and the RMS (+1e-6) of each library
        column: y_win [N, k+1, n], u_win [N, k, m]."""
        xs = torch.cat([y_win[:, :-1], u_win], dim=-1)
        phi = features(y_win[:, :-1], u_win, self.terms)
        return {"mu": xs.mean(dim=(0, 1)),
                "sigma": xs.std(dim=(0, 1), correction=0) + 1e-6,
                "phi_scale": phi.square().mean(dim=(0, 1)).sqrt() + 1e-6}


# -- guard and scenario ------------------------------------------------------ #
BLOWUP = 1e6


@torch.no_grad()
def guard_score(theta, ys, us, dt, terms, tf32=False):
    """Normalized rollout error [B]: mean squared gap of the RK4 rollout
    from ys[:, 0] under us to ys, over the variance of ys (+1e-6);
    non-finite -> 1e6."""
    est = rk4(theta, ys[:, 0], us, dt, terms, tf32)
    num = torch.square(est - ys).mean(dim=(1, 2))
    den = torch.square(ys - ys.mean(dim=1, keepdim=True)).mean(dim=(1, 2))
    return torch.nan_to_num(num / (den + 1e-6), nan=BLOWUP, posinf=BLOWUP)


def ema(prev: float, score: float, weight: float) -> float:
    return weight * min(float(score), BLOWUP) + (1 - weight) * prev


def judge(div: float, refit: float, alert: float) -> str:
    return "ALERT" if div > alert else "REFIT" if div > refit else "OK"


@torch.no_grad()
def scenario(theta_hist, count: int, y0, us, dt, terms, tf32=False):
    """What-if rollouts over the ensemble of the E newest served models
    (unfilled entries take the live one): theta_hist [E, n, L], y0 [n], us
    [K, H, m] -> (center [K, H+1, n] from the live model, lo, hi, the
    ensemble envelope, confidence [K] = 1 / (1 + mean envelope width /
    population std of the center))."""
    E = theta_hist.shape[0]
    live = max(count - 1, 0) % E
    ens = torch.stack([theta_hist[e] if e < count else theta_hist[live]
                       for e in range(E)])
    K = us.shape[0]
    ys = rk4(ens[:, None].expand(E, K, *ens.shape[1:]),
             y0.expand(E, K, y0.shape[-1]), us.expand(E, *us.shape), dt,
             terms, tf32)
    ys = torch.nan_to_num(ys, nan=BLOWUP, posinf=BLOWUP,
                          neginf=-BLOWUP).clamp(-BLOWUP, BLOWUP)
    center, lo, hi = ys[live], ys.amin(0), ys.amax(0)
    width = (hi - lo).mean(dim=(1, 2))
    conf = 1.0 / (1.0 + width / (center.std(dim=(1, 2), correction=0)
                                 + 1e-6))
    return center, lo, hi, conf


def relative_gap(got, want, floor: float = 0.0) -> float:
    """max |got - want| / max(|want|, floor), over all entries."""
    got, want = got.double(), want.double()
    den = torch.clamp(want.abs(), min=floor) if floor else want.abs()
    gap = (got - want).abs() / torch.clamp(den, min=1e-300)
    return float(gap.max()) if gap.numel() else 0.0


def norm_gap(got, want, median: float) -> float:
    """|‖got‖ - ‖want‖| / max(‖want‖, median): the gap of two norms."""
    g, w = float(got.double().norm()), float(want.double().norm())
    return abs(g - w) / max(w, median, 1e-300)


__all__ = ["library_terms", "library_names", "f8_coefficients", "f8_theta",
           "tf32_round", "features", "rk4", "Refit", "guard_score", "ema",
           "judge", "scenario", "relative_gap", "norm_gap", "BLOWUP"]
