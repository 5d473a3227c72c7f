"""The GRU scan kernel's share of its roofline (csrc/gru_scan.cu): the
least time of every launch in the traced segment (work.py, at the operand
shapes recorded at the kernel's entry point) over the kernel's device
time, in percent.  Nothing when the launches recorded and traced differ."""


def read(run):
    t = run.trace
    if t is None:
        return None
    events = t.kernels("gru_scan")
    shapes = t.shapes.get("gru", [])
    if not events or len(events) != len(shapes):
        return None
    w = run.work
    bound = 0.0
    for xs, h0, *_ in shapes:
        F, B, T, D = xs
        H = h0[-1]
        bound += w.bound_ms(w.gru_flops(F, B, T, H, D),
                            w.gru_bytes(F, B, T, H, D))
    return 100.0 * bound / (sum(d for _, d, _ in events) / 1e6)
