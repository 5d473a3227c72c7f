"""Every span of a tick in which the host waits on the device
(`guard.wait`, `refit.wait`, `promote.wait`, `tick.wait`), from the span
segment (spans.py): ms a tick, summed over shards."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "tick", *spans.TICK_WAITS)
