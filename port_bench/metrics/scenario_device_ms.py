"""Device time of the operations that start inside each what-if query's
range in the traced segment (twin/scenario.py), mean a query, in ms."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    ranges = t.named_ranges("bench.query")
    if not ranges:
        return None
    total = sum(d for lo, hi in ranges for _, d, _ in t.within(lo, hi))
    return total / 1e6 / len(ranges)
