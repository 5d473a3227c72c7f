"""Each window tick's slowest worker: the largest `latency_s` among the
tick's `TickDone` replies (a worker's own `TwinServer.tick`, to its device
synchronize, on its clock); mean a tick of the window, in ms.  Only a
federated configuration's ticks carry it."""


def read(run):
    vals = [t["worker_s"] for t in run.ticks if "worker_s" in t]
    return 1e3 * sum(vals) / len(vals) if vals else None
