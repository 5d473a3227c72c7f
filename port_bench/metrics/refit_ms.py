"""The port's own `stage_times["refit"]` (host clock, up to and including
the tick's device synchronize), summed over the shards of each tick; mean
a tick of the window.  The refit stage absorbs device work that earlier
stages queued."""


def read(run):
    vals = [t["stages"]["refit"] for t in run.ticks
            if "refit" in t.get("stages", {})]
    return 1e3 * sum(vals) / len(vals) if vals else None
