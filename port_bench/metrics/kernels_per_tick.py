"""Device kernel executions in the traced segment, per tick (copies and
fills not counted): the host's dispatch work."""


def read(run):
    t = run.trace
    if t is None or not t.ticks or not t.device:
        return None
    return len(t.kernels()) / t.ticks
