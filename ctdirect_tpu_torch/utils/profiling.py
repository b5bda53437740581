"""Lightweight timing / profiling helpers (PyTorch port of
`ctdirect_tpu.utils.profiling`): wall-clock timing with device
synchronization, and `torch.profiler` tracing into a Chrome trace; on a
card, a profile that counts the CUDA kernels it saw and the activity
records CUPTI dropped (`kernel_events`, `profiled_solve`), the device
time of a profiled run split by the stages that were open on the host when
each kernel was launched (`ranged`, `kkt_ranges`, `stage_split`; of MPC
ticks, `tick_stage_split`), and the
device's idle time of a profiled compiled solve split by the segment whose
host window it falls in (`segment_ranges`, `segment_split`)."""

from __future__ import annotations

import contextlib
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import torch

# the file `trace` writes into its logdir (chrome://tracing, Perfetto)
TRACE_FILE = "trace.json"
# the CR kernel's CUDA kernels (csrc/cr_solve.cu), as the profiler names them;
# pack and unpack are transpose_kernel
CR_KERNELS = re.compile(r"\b(up_odd|up_even|root_solve|down|transpose_kernel)<")
# NCCL's kernels (its collectives and point-to-point messages)
NCCL_KERNELS = re.compile(r"nccl", re.I)
# kineto's warning when CUPTI had no buffer room for activity records
_DROPPED = re.compile(rb"Dropped (\d+) activity records")
# kernel_events' profiles of one call at most (a profile that lost records is taken again)
PROFILE_TRIES = 3
# idle s that device_profile keeps inside the profiler before and after the
# profiled call. On the H100 the device's timestamps read 16-25 ms later than
# the host's clock, and a profile stopped right after the call now and then
# lost the call's last kernels (the last 1-4 CR solves of a graphed batch
# solve): tools/profile_misses.py saw 2 of 67 profiles short at 0 s, 0 of 68
# at 0.1 s
PROFILE_MARGIN_S = 0.1
# the prefix of the profiler ranges that `ranged` opens and `stage_split` reads
STAGE = "stage:"
# the prefix of the ranges that `segment_ranges` opens and `segment_split` reads
SEGMENT = "segment:"
# the KKT operator's methods that `kkt_ranges` wraps, and the stage each is reported as
KKT_STAGES = {"prepare": "prepare", "solve": "solve (other)", "_assemble": "assemble",
              "_block_solve": "block solve (casts, pad)"}


@dataclass
class Timings:
    records: Dict[str, List[float]] = field(default_factory=dict)

    def add(self, name: str, seconds: float):
        self.records.setdefault(name, []).append(seconds)

    def summary(self) -> str:
        lines = []
        for name, vals in self.records.items():
            v = sorted(vals)
            p50 = v[len(v) // 2]
            lines.append(
                f"{name}: n={len(v)} p50={p50*1e3:.2f}ms "
                f"min={v[0]*1e3:.2f}ms max={v[-1]*1e3:.2f}ms"
            )
        return "\n".join(lines)


GLOBAL_TIMINGS = Timings()


def _synchronize(obj):
    """Wait for the CUDA devices of `obj`: a tensor, a device (or its name),
    or a list / tuple / dict of them. CPU work is already done when a torch
    call returns; anything else is ignored."""
    if isinstance(obj, torch.Tensor):
        obj = obj.device
    if isinstance(obj, str):
        obj = torch.device(obj)
    if isinstance(obj, torch.device):
        if obj.type == "cuda":
            torch.cuda.synchronize(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _synchronize(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _synchronize(v)


@contextlib.contextmanager
def timed(name: str, timings: Optional[Timings] = None, sync=None):
    """Context manager timing a block; `sync` is a tensor, a device, or a
    list / tuple / dict of them whose CUDA devices are synchronized before
    the clock stops (`torch.cuda.synchronize(dev)`)."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        _synchronize(sync)
    (timings or GLOBAL_TIMINGS).add(name, time.perf_counter() - t0)


def benchmark(fn: Callable, *args, warmup: int = 1, reps: int = 5) -> dict:
    """Time a callable: the first call + steady-state p50. Each call ends
    with a synchronize of the CUDA devices of its output's tensors.

    `compile_s` (the JAX package's key name) is the first call, which
    includes whatever runs once: a CUDA kernel's build, CUDA's lazy
    initialization and the caching allocator's first allocations."""
    t0 = time.perf_counter()
    _synchronize(fn(*args))
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        _synchronize(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _synchronize(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return {
        "compile_s": compile_s,
        "p50_s": ts[len(ts) // 2],
        "min_s": ts[0],
        "max_s": ts[-1],
        "reps": reps,
    }


@contextlib.contextmanager
def trace(logdir: str, activities: Iterable[torch.profiler.ProfilerActivity]):
    """torch.profiler over the block with the given `activities` (e.g.
    `[ProfilerActivity.CPU, ProfilerActivity.CUDA]`; nothing here looks for
    a card). Yields the profiler; on exit writes a Chrome trace to
    `logdir/TRACE_FILE`."""
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=list(activities)) as prof:
        yield prof
    prof.export_chrome_trace(str(out / TRACE_FILE))


@contextlib.contextmanager
def _stderr_to(f):
    """File descriptor 2 (where kineto writes its warnings) into the file
    `f` over the block."""
    sys.stderr.flush()
    saved = os.dup(2)
    os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def device_profile(fn):
    """fn() under torch.profiler (CPU and CUDA activities), synchronized.
    Returns (fn's result, profile, wall s, dropped): `dropped` sums CUPTI's
    dropped activity records as kineto reports them on stderr (copied back
    there) while it profiles and stops. Kineto prints warnings only where
    KINETO_LOG_LEVEL is at most 2 when its profiler first starts in the
    process; PyTorch otherwise keeps only its errors, and `dropped` reads 0."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with tempfile.TemporaryFile() as f:
        with _stderr_to(f):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(PROFILE_MARGIN_S)
        f.seek(0)
        err = f.read()
    os.write(2, err)
    return out, prof, wall, dropped_records(err)


def dropped_records(err: bytes) -> int:
    """The activity records that kineto's warnings in `err` (stderr's bytes)
    say CUPTI dropped."""
    return sum(int(n) for n in _DROPPED.findall(err))


def _raw_events(prof):
    """(device events as (name, ns, linked host op), host ops' start ns by
    correlation id, stage ranges as (start ns, end ns, stage)) of a profile,
    read from the profiler's raw events: its parsed tree (`key_averages`,
    `events`) takes minutes to build for a run of ~10^5 kernels or ~10^6
    ops. Device names are demangled as the profiler's tables show them;
    user annotations (the ranges' device spans) are no device events."""
    device, op_start, ranges, names = [], {}, [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type().name == "CPU":
            if name.startswith(STAGE):
                ranges.append((e.start_ns(), e.end_ns(), name[len(STAGE):]))
            elif e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
        elif not (e.is_user_annotation() or name.startswith(STAGE)):
            if name not in names:
                names[name] = torch._C._demangle(name)
            device.append((names[name], e.duration_ns(), e.linked_correlation_id()))
    return device, op_start, ranges


def device_totals(prof) -> dict:
    """A profile's device busy s, CR kernel s and CUDA launches (events) of
    the CR kernel (CR_KERNELS), of NCCL and of all device work."""
    device, _, _ = _raw_events(prof)
    cr = [ns for name, ns, _ in device if CR_KERNELS.search(name)]
    nccl = sum(1 for name, _, _ in device if NCCL_KERNELS.search(name))
    return dict(busy=sum(ns for _, ns, _ in device) / 1e9, cr=sum(cr) / 1e9, cr_events=len(cr), nccl_events=nccl,
                events=len(device))


def kernel_events(fn) -> dict:
    """fn() under `device_profile`; fn returns the CR kernel's CUDA
    launches that its call makes (from the wrapper's counts), and the
    profiler must see that many (CR_KERNELS). A profile in which CUPTI
    dropped records cannot count them: it is taken again, PROFILE_TRIES
    profiles at most. Raises AssertionError on a count that differs with
    nothing dropped, or when every profile dropped records. Returns prof,
    wall, the profile's `device_totals`, want, seen, dropped (summed over
    the profiles) and tries."""
    dropped = 0
    for k in range(1, PROFILE_TRIES + 1):
        want, prof, wall, lost = device_profile(fn)
        totals = device_totals(prof)
        seen = totals["cr_events"]
        dropped += lost
        if seen == want or not lost:
            break
    if seen != want:
        raise AssertionError(f"{seen} kernel events in the profile, planned {want} ({k} profiles, {dropped} "
                             f"activity records dropped)")
    return dict(prof=prof, wall=wall, totals=totals, want=want, seen=seen, dropped=dropped, tries=k)


def profiled_solve(solve, solves, per, graph=None) -> dict:
    """A solve under torch.profiler (`kernel_events`, which raises unless
    the profiler sees the CR kernel's planned CUDA launches: the block
    solves that `solves()` counts in the call x `per`, the CUDA launches of
    one): its wall s, device busy s, CR kernel s, the CR kernel's CUDA
    launches seen, all kernel launches seen, the profiler's dropped
    records and profiles, and `block_solves`, those of every profile taken
    (each runs the solve again). With `graph` (the BatchGraph the solve runs its
    segments through), also `segments`: the device's idle time split by
    segment (`segment_ranges`, `segment_split`)."""
    total = 0

    def run():
        nonlocal total
        n0 = solves()
        solve()
        total += solves() - n0
        return (solves() - n0) * per

    with segment_ranges(graph) if graph is not None else contextlib.nullcontext():
        rec = kernel_events(run)
    t = rec["totals"]
    out = dict(wall=rec["wall"], busy=t["busy"], cr=t["cr"], cr_launches=rec["seen"], launches=t["events"],
               dropped=rec["dropped"], tries=rec["tries"], block_solves=total)
    if graph is not None:
        out["segments"] = segment_split(rec["prof"])
    return out


@contextlib.contextmanager
def segment_ranges(graph):
    """Over the block, each segment that `graph` (solver/graph.py's
    BatchGraph) runs does so inside a profiler range named SEGMENT + the
    segment's name (`graph.run` wrapped on the instance, taken off after)."""
    from torch.profiler import record_function

    run = graph.run

    def wrapped(name):
        with record_function(SEGMENT + name):
            return run(name)

    graph.run = wrapped
    try:
        yield graph
    finally:
        del graph.run


def segment_split(prof) -> Dict[str, dict]:
    """The device's idle time in a profile of a solve run with
    `segment_ranges`, split by the segment whose host window it falls in.
    A segment's window runs from the start of its range to the start of the
    next segment's, so it holds the segment's replay and the host's work up
    to the next segment (the flag reads and decisions after it); "set-up"
    is the time before the first segment, "epilogue" the time after the
    last one's range, to the end of the last event. The device is busy
    where a device event runs (their union) and idle elsewhere. Returns
    name -> dict(runs, window_s, busy_s, idle_s), in the order of first
    use, set-up first and epilogue last."""
    import bisect

    windows, spans, first, last = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
        if e.device_type().name == "CPU":
            if name.startswith(SEGMENT):
                windows.append([start, end, name[len(SEGMENT):]])
        elif not (e.is_user_annotation() or name.startswith((STAGE, SEGMENT))):
            spans.append((start, end))
    if first is None:
        return {}
    windows.sort()
    # a window ends where the next segment starts; the last at its range's end
    for w, nxt in zip(windows, windows[1:]):
        w[1] = nxt[0]
    head = windows[0][0] if windows else last
    tail = windows[-1][1] if windows else last
    windows = [[first, head, "set-up"], *windows, [tail, last, "epilogue"]]

    # the union of the device spans, and its busy ns before each span's start
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    before = [0]
    for s, e in merged:
        before.append(before[-1] + e - s)

    def busy_until(t):
        j = bisect.bisect_right(starts, t) - 1
        if j < 0:
            return 0
        s, e = merged[j]
        return before[j] + min(t, e) - s

    split = {}
    for a, b, name in windows:
        rec = split.setdefault(name, dict(runs=0, window_s=0.0, busy_s=0.0, idle_s=0.0))
        busy = busy_until(b) - busy_until(a)
        rec["runs"] += name not in ("set-up", "epilogue")
        rec["window_s"] += (b - a) / 1e9
        rec["busy_s"] += busy / 1e9
        rec["idle_s"] += (b - a - busy) / 1e9
    return split


def ranged(stage: str, fn: Callable) -> Callable:
    """fn, each call of it inside a profiler range named STAGE + stage."""
    from torch.profiler import record_function

    def wrapped(*args, **kw):
        with record_function(STAGE + stage):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def kkt_ranges(kkt):
    """Over the block, the KKT operator's methods of KKT_STAGES run inside
    profiler ranges (`ranged`, set on the instance and taken off after).
    A segment graph captured before keeps the kernels it holds."""
    own = {name: vars(kkt)[name] for name in KKT_STAGES if name in vars(kkt)}
    for name, stage in KKT_STAGES.items():
        setattr(kkt, name, ranged(stage, getattr(kkt, name)))
    try:
        yield kkt
    finally:
        for name in KKT_STAGES:
            if name in own:
                setattr(kkt, name, own[name])
            else:
                delattr(kkt, name)


def tick_stage_split(make_ctrl, states, xs, ticks: int) -> Dict[str, float]:
    """Device ms per tick by stage (`stage_split`) of `ticks` eager ticks
    (MPCController.eager) from `states` over xs, for a controller built by
    make_ctrl() while these run in profiler ranges (for this run only):
    `mpc.shift_state` (shift), the resolve's gradients and vector-Jacobian
    products (derivatives: grad f, J^T lam), and the KKT operator's prepare,
    _assemble, _block_solve and the rest of its solve (`kkt_ranges`). A
    kernel launched outside every range goes to "update" (x0 rows, barrier
    terms, residuals, the step to the boundary, the state update, the exit
    norms). The replayed tick runs the same kernels in the same order."""
    from ctdirect_tpu_torch.parallel import mpc
    from ctdirect_tpu_torch.solver import resolve

    grad, vjp, shift = resolve.grad, resolve.vjp, mpc.shift_state

    def vjp_ranged(fn, *primals):
        out, back = ranged("derivatives", vjp)(fn, *primals)
        return out, ranged("derivatives", back)

    def run():
        s = states
        for x0 in xs[:ticks]:
            s, *_ = ctrl.eager(s, x0)

    resolve.grad, resolve.vjp = (lambda fn: ranged("derivatives", grad(fn))), vjp_ranged
    mpc.shift_state = ranged("shift", shift)
    try:
        ctrl = make_ctrl()
        with kkt_ranges(ctrl.kkt):
            _, prof, _, _ = device_profile(run)
    finally:
        resolve.grad, resolve.vjp, mpc.shift_state = grad, vjp, shift
    return stage_split(prof, ticks, outside="update")


def stage_split(prof, calls: int, outside: str) -> Dict[str, float]:
    """Device ms per call by stage of a profile (`device_profile`) of
    `calls` calls run with stage ranges open (`ranged`). Each device event
    goes to the innermost range open on the host when the op that launched
    it started (on any thread: the gradients' backward launches from the
    autograd engine's), the CR kernel's to "CR kernel" (from the kernel
    table: its ctypes launches link to no host op), and one launched outside
    every range to `outside`; device time that links to no host op is "not
    linked to a host event" (`_raw_events`)."""
    import bisect

    device, op_start, ranges = _raw_events(prof)
    ranges.sort()
    starts = [r[0] for r in ranges]
    # parent[i]: the innermost range that holds range i's start (the ranges nest)
    parent, open_ = [], []
    for i, (start, end, _) in enumerate(ranges):
        while open_ and ranges[open_[-1]][1] < start:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)

    def stage_at(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ranges[i][1] < t:
            i = parent[i]
        return ranges[i][2] if i >= 0 else outside

    split = {}
    for name, ns, op in device:
        if CR_KERNELS.search(name):
            stage = "CR kernel"
        elif op in op_start:
            stage = stage_at(op_start[op])
        else:
            stage = "not linked to a host event"
        split[stage] = split.get(stage, 0.0) + ns / calls / 1e6
    return split
