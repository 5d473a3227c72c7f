"""Each window tick's slowest worker-side ingest: the largest, over the
workers, of the seconds a worker's own `TwinServer.ingest_many` took on
the batches that arrived since its previous tick (timed in the worker,
around the program's call); mean a tick of the window, in ms.  Only a
federated configuration's ticks carry it."""


def read(run):
    vals = [t["worker_ingest_s"] for t in run.ticks
            if "worker_ingest_s" in t]
    return 1e3 * sum(vals) / len(vals) if vals else None
