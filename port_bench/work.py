"""The yardstick's arithmetic, frozen with the benchmark.

NVIDIA's data-sheet peaks of one H100 SXM (dense, at the 700 W limit) and
the operations of the port's two hand-written kernels, copied from the
program's `kernels/work.py` and `launch/mesh.py` so that a later change to
the program cannot move the yardstick.  Operations count 2 per
multiply-add; bytes count each input read and each output written once.

`tick_flops` counts the model work of one serving tick from the cell's
shapes: the refit step's GRU, dense head, RK4 decode and collocation
products, three times (forward and backward), for every slot of every
shard and every step; the guard's rollout, and the promote's candidate
extraction (GRU and head) and its two shadow rollouts, once.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # TF32 tensor cores
HBM_BW = 3.35e12             # bytes/s


def library_size(n: int, m: int, order: int) -> int:
    from math import comb
    return comb(order + n + m, n + m)


def gru_flops(F: int, B: int, T: int, H: int, D: int) -> float:
    """x Wx, h Wh_zr and (r*h) Wh_c a step, F x B sequences."""
    return 2.0 * F * B * T * (D * 3 * H + 3 * H * H)


def rk4_flops(B: int, T: int, n: int, L: int, O: int) -> float:
    """Per right-hand side, (O-1) products a library term for Phi and n*L
    multiply-adds; four right-hand sides a step."""
    return 4.0 * B * T * (L * (O - 1) + 2 * n * L)


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time of a kernel on the card: the larger of its f32
    operations' time and its bytes' time, in ms."""
    return max(flops / PEAK_F32_FLOPS, nbytes / HBM_BW) * 1e3


def gru_bytes(F: int, B: int, T: int, H: int, D: int) -> float:
    """xs, h0, wx, wh, b in; hs, hT out (f32)."""
    return 4.0 * (F * B * T * D + F * B * H + F * D * 3 * H
                  + F * H * 3 * H + F * 3 * H + F * B * T * H + F * B * H)


def rk4_bytes(B: int, T: int, n: int, L: int, O: int, m: int) -> float:
    """theta, y0, us, term indices in; ys out (f32, int32)."""
    return 4.0 * (B * n * L + B * n + B * T * m + L * O + B * (T + 1) * n)


def encode_flops(F: int, B: int, T: int, mer: dict) -> float:
    """GRU and dense head over F x B windows of T steps."""
    n, m, H, hh = mer["n"], mer["m"], mer["hidden"], mer["head_hidden"]
    L = library_size(n, m, mer["order"])
    head = 2.0 * F * B * (2 * H * hh + hh * (n * L + m))
    return gru_flops(F, B, T, H, n + m) + head


def refit_step_flops(cfg: dict) -> float:
    """One train step of one shard's refit pool, forward and backward."""
    mer, s = cfg["merinda"], cfg["server"]
    F, B, T = s["refit_slots"], s["windows_per_twin"], s["window"]
    n, m, O = mer["n"], mer["m"], mer["order"]
    L = library_size(n, m, O)
    fwd = (encode_flops(F, B, T, mer) + rk4_flops(F * B, T, n, L, O)
           + 2.0 * F * B * (T - 1) * n * L)
    return 3.0 * fwd


def guard_flops(cfg: dict) -> float:
    """One shard's guard rollout: the whole store, or the rotation's fixed
    width (budget plus a quarter of it carried)."""
    mer, s = cfg["merinda"], cfg["server"]
    n, m, O = mer["n"], mer["m"], mer["order"]
    width = (s["max_twins"] if s["guard_budget"] is None
             else s["guard_budget"] + s["guard_budget"] // 4)
    return rk4_flops(width, cfg["guard"]["window"], n,
                     library_size(n, m, O), O)


def promote_flops(cfg: dict) -> float:
    """One shard's promote: candidate extraction and two shadow rollouts
    over every slot."""
    mer, s = cfg["merinda"], cfg["server"]
    F = s["refit_slots"]
    n, m, O = mer["n"], mer["m"], mer["order"]
    L = library_size(n, m, O)
    return (encode_flops(F, s["windows_per_twin"], s["window"], mer)
            + 2 * rk4_flops(F, cfg["guard"]["window"], n, L, O))


def tick_flops(cfg: dict, promotes: int) -> float:
    """A tick's model work over every shard; `promotes` shards promoted."""
    per_shard = (cfg["server"]["steps_per_tick"] * refit_step_flops(cfg)
                 + guard_flops(cfg))
    return cfg["shards"] * per_shard + promotes * promote_flops(cfg)


def scenario_flops(cfg: dict, k: int, horizon: int) -> float:
    """One what-if query: the ensemble x K rollouts."""
    mer = cfg["merinda"]
    n, m, O = mer["n"], mer["m"], mer["order"]
    return rk4_flops(cfg["scenario"]["ensemble"] * k, horizon, n,
                     library_size(n, m, O), O)
