"""The program's `pump_flush` spans (the host merge and pad of staged
telemetry, twin/stream.py), from the span segment (spans.py): ms a tick,
summed over shards."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "tick", "pump_flush")
