"""The port's own `stage_times["guard"]` (host clock), summed over the
shards of each tick; mean a tick of the window."""


def read(run):
    vals = [t["stages"]["guard"] for t in run.ticks
            if "guard" in t.get("stages", {})]
    return 1e3 * sum(vals) / len(vals) if vals else None
