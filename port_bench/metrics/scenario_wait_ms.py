"""The program's `scenario.wait` span (the what-if answer's copies to the
host, twin/scenario.py), from the span segment (spans.py): ms a query."""
from port_bench import spans


def read(run):
    return spans.host_ms(run, "scenario", "scenario.wait")
