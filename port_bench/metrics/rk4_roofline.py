"""The RK4 polynomial-ODE kernel's share of its roofline
(csrc/rk4_poly.cu): the least time of every launch in the traced segment
(work.py, at the operand shapes recorded at the kernel's entry point) over
the kernel's device time, in percent.  Nothing when the launches recorded
and traced differ."""


def read(run):
    t = run.trace
    if t is None:
        return None
    events = t.kernels("rk4_poly")
    shapes = t.shapes.get("rk4", [])
    if not events or len(events) != len(shapes):
        return None
    w = run.work
    bound = 0.0
    for theta, _y0, us, idx in shapes:
        B, n, L = theta
        T, m = us[1], us[2]
        O = idx[1]
        bound += w.bound_ms(w.rk4_flops(B, T, n, L, O),
                            w.rk4_bytes(B, T, n, L, O, m))
    return 100.0 * bound / (sum(d for _, d, _ in events) / 1e6)
