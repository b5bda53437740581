"""device_idle_pct.tick: 100 x (1 - the device's busy ms a tick / the
window's mean closed-loop tick ms). Busy is the union of every device
event's span over the traced slice of replayed closed-loop ticks, over its
ticks; the tick's ms are the window's CUDA-event times, taken without the
profiler, which slows each graph launch by milliseconds (PERF.md)."""


def read(run):
    r = run["rec"]
    if run["kind"] != "closed_loop_tick" or not r.get("busy_ms_per_tick"):  # no device event seen
        return None
    return 100.0 * (1.0 - r["busy_ms_per_tick"] / (sum(r["tick_ms"]) / len(r["tick_ms"])))
