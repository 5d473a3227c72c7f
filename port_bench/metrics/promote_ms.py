"""The program's `promote` spans (recover, shadow scores, their wait,
deploy), from the span segment (spans.py): ms a tick, summed over shards;
0 where no tick promoted."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "tick", "promote")
