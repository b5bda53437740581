"""device_idle_pct.batch: 100 x (1 - the device's busy seconds in one traced
graphed BatchSolver call / the window's mean call seconds, host clock, taken
without the profiler, which slows each graph launch; PERF.md)."""


def read(run):
    r = run["rec"]
    if run["kind"] != "cold_batch" or not r.get("busy_s"):  # no device event seen: nothing to read
        return None
    return 100.0 * (1.0 - r["busy_s"] / (r["window_s"] / r["calls"]))
