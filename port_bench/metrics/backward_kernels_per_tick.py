"""Device kernels launched inside the program's `refit.backward` spans,
from the attributed segment (spans.py): a tick, summed over shards."""
from port_bench import spans


def read(run):
    return spans.kernels(run, "refit.backward")
