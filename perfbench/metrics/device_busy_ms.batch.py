"""device_busy_ms.batch: the device's busy ms in one traced graphed
BatchSolver call (the union of every device event's span). It reads the
same in both of the host's modes (PERF.md), so it shows a change in the
call's device work that the window's rate cannot resolve."""


def read(run):
    r = run["rec"]
    if run["kind"] != "cold_batch" or not r.get("busy_s"):  # no device event seen
        return None
    return 1e3 * r["busy_s"]
