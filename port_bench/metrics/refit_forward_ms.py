"""The program's `refit.forward` spans (Merinda.loss: GRU encoder, head,
sparsify, RK4 decode, enqueued), from the span segment (spans.py): ms a
tick, over every train step, summed over shards."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "tick", "refit.forward")
