"""Device kernel executions that start inside each what-if query's range
in the traced segment, mean a query."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    ranges = t.named_ranges("bench.query")
    if not ranges:
        return None
    n = sum(1 for lo, hi in ranges for ev in t.within(lo, hi)
            if t.is_kernel(ev[2]))
    return n / len(ranges)
