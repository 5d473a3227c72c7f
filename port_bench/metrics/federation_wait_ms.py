"""The coordinator's share of each window tick: the tick on the
benchmark's clock (`tick()` and a synchronize) less its slowest worker's
`latency_s`, i.e. fan-out of `TickCmd`, the pipes, collecting the replies
and rebalancing, and the workers' own `ingest_many` of the tick's batches
where it still runs when `TickCmd` arrives (`worker_ingest_ms` reads that
ingest alone); mean a tick of the window, in ms.  Only a federated
configuration's ticks carry it."""


def read(run):
    vals = [t["tick_s"] - t["worker_s"] for t in run.ticks if "worker_s" in t]
    return 1e3 * sum(vals) / len(vals) if vals else None
