"""The program's `refit.backward` spans (autograd through both kernels'
backwards, enqueued), from the span segment (spans.py): ms a tick, over
every train step, summed over shards."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "tick", "refit.backward")
