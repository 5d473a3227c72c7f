"""The program's `ingest_many` span (telemetry staging, twin/stream.py),
from the span segment (spans.py): ms a tick, summed over shards.  The
program's counterpart of `ingest_host_ms`."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "ingest_many", "ingest_many")
