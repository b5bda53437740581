"""device_busy_ms.tick: the device's busy ms a tick (the union of every
device event's span over the traced slice of replayed closed-loop ticks,
over its ticks). It reads the same in both of the host's modes (PERF.md),
so it shows a change in the tick's device work that the window's rate,
whose runs spread by the host's mode, cannot resolve."""


def read(run):
    r = run["rec"]
    if run["kind"] != "closed_loop_tick" or not r.get("busy_ms_per_tick"):  # no device event seen
        return None
    return r["busy_ms_per_tick"]
