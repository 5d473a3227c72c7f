"""The port's own `stage_times["schedule"]` (host clock), summed over the
shards of each tick; mean a tick of the window."""


def read(run):
    vals = [t["stages"]["schedule"] for t in run.ticks
            if "schedule" in t.get("stages", {})]
    return 1e3 * sum(vals) / len(vals) if vals else None
