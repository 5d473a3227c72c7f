"""Host milliseconds of each tick's `ingest_many` (telemetry staging,
twin/stream.py), on the benchmark's clock; mean a tick of the window."""


def read(run):
    if not run.ticks:
        return None
    return 1e3 * sum(t["ingest_s"] for t in run.ticks) / len(run.ticks)
