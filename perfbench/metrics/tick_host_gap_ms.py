"""tick_host_gap_ms: the host's share of a closed-loop tick, ms a tick, over
the window: the window's host-clock time less the sum of its ticks'
CUDA-event times (each from before x0's copy to the card to after u0's copy
to the host), over the ticks."""


def read(run):
    return run["rec"]["host_gap_ms"] if run["kind"] == "closed_loop_tick" else None
