"""What the benchmark reads from a torch.profiler trace of the program: the
device's busy time, the device time by the benchmark's own host ranges, the
kernels that took the most time, and the idle gaps named by the host ranges
around them.

The attribution arithmetic is a copy of the program's utilities
(`utils/profiling.py`: `device_profile`, `_raw_events`, `stage_split`,
`segment_split`), kept here so that the yardstick does not move with the
program. The ranges are the benchmark's own (`rng`): the benchmark opens them
around its calls into the program's layers, and a kernel goes to the
innermost range open on the host when the op that launched it started. A
kernel launched through ctypes links to no host op: it goes to a group by its
name, from the name lists of perfbench/kernels/ (one file a group, one regular
expression a line), so that a later kernel adds its names as a new file."""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from pathlib import Path

import torch

PREFIX = "perfbench:"
# idle seconds the profile keeps before and after the profiled call: on the
# H100 a profile stopped right after the call lost the call's last kernels
# now and then (the program's utils/profiling.py, PROFILE_MARGIN_S)
MARGIN_S = 0.1
KERNELS = Path(__file__).resolve().parent / "kernels"


def kernel_groups() -> dict:
    """group name -> compiled pattern, one group per file of perfbench/kernels/."""
    out = {}
    for path in sorted(KERNELS.glob("*.txt")):
        lines = [ln.strip() for ln in path.read_text().splitlines()]
        pats = [ln for ln in lines if ln and not ln.startswith("#")]
        out[path.stem] = re.compile("|".join(f"(?:{p})" for p in pats))
    return out


def rng(name: str):
    """A profiler range of the benchmark's own, named PREFIX + name."""
    return torch.profiler.record_function(PREFIX + name)


def profile(fn):
    """fn() under torch.profiler (CPU and CUDA activities), synchronized,
    with MARGIN_S of idle before and after. Returns (fn's result, profile,
    host-clock seconds of the call itself)."""
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
        time.sleep(MARGIN_S)
    return out, prof, wall


class Trace:
    """A profile's raw events (the profiler's parsed tree takes minutes for
    10^5 kernels): device events (name, start ns, end ns, correlation id of
    the host op that launched it), host ops' start ns by correlation id, and
    the benchmark's ranges (start ns, end ns, name)."""

    def __init__(self, prof):
        self.device, self.op_start, self.ranges, names = [], {}, [], {}
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type().name == "CPU":
                if name.startswith(PREFIX):
                    self.ranges.append((e.start_ns(), e.end_ns(), name[len(PREFIX):]))
                elif e.linked_correlation_id() == 0:
                    self.op_start[e.correlation_id()] = e.start_ns()
            elif not (e.is_user_annotation() or name.startswith(PREFIX)):
                if name not in names:
                    names[name] = torch._C._demangle(name)
                start = e.start_ns()
                self.device.append((names[name], start, start + e.duration_ns(), e.linked_correlation_id()))
        self.ranges.sort()
        self._starts = [r[0] for r in self.ranges]
        # parent[i]: the innermost range that holds range i's start (ranges nest)
        self._parent, open_ = [], []
        for i, (start, _, _) in enumerate(self.ranges):
            while open_ and self.ranges[open_[-1]][1] < start:
                open_.pop()
            self._parent.append(open_[-1] if open_ else -1)
            open_.append(i)
        self.groups = kernel_groups()

    def range_at(self, t, outside="outside"):
        """The innermost benchmark range open on the host at host time t."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self._parent[i]
        return self.ranges[i][2] if i >= 0 else outside

    def group(self, name):
        for g, pat in self.groups.items():
            if pat.search(name):
                return g
        return None

    def stage_of(self, name, corr, outside):
        """A device event's stage: its kernel group, else the innermost range
        open when its host op started, else `outside`, else (no host op)
        "unlinked (a graph's kernels)"."""
        g = self.group(name)
        if g is not None:
            return "kernel:" + g
        if corr in self.op_start:
            return self.range_at(self.op_start[corr], outside)
        return "unlinked (a graph's kernels)"

    def busy_s(self) -> float:
        """Seconds in which some device event ran (the union of their spans)."""
        return sum(e - s for s, e in self._merged()) / 1e9

    def _merged(self):
        merged = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def stage_ms(self, calls: int, outside: str) -> dict:
        """Device ms a call by stage (`stage_of`) over `calls` calls."""
        split = {}
        for name, s, e, corr in self.device:
            stage = self.stage_of(name, corr, outside)
            split[stage] = split.get(stage, 0.0) + (e - s) / calls / 1e6
        return split

    def top_ops(self, k: int = 10) -> list:
        """[kernel name, device s] of the k device operations that took the
        most time, summed by name."""
        total = {}
        for name, s, e, _ in self.device:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, k: int = 10) -> list:
        """[name, idle s] of the longest idle stretches between device events,
        summed by name: the benchmark range that launched the work before
        the gap and the one that launched the work after it (host times
        only, so no clock is compared with another)."""
        events = sorted(self.device, key=lambda d: d[1])
        total, end, before = {}, None, None
        for name, s, e, corr in events:
            here = self.stage_of(name, corr, "outside")
            if end is not None and s > end:
                key = f"{before} -> {here}"
                total[key] = total.get(key, 0) + (s - end)
            if end is None or e >= end:
                end, before = e, here
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:200], ns / 1e9] for name, ns in top]


@contextlib.contextmanager
def wrapped(obj, names: dict):
    """Over the block, each method `m` of `obj` named in `names` runs inside
    the range names[m] (set on the instance, taken off after)."""
    own = {m: vars(obj)[m] for m in names if m in vars(obj)}

    def wrap(fn, stage):
        def inner(*args, **kw):
            with rng(stage):
                return fn(*args, **kw)
        return inner

    for m, stage in names.items():
        setattr(obj, m, wrap(getattr(obj, m), stage))
    try:
        yield obj
    finally:
        for m in names:
            if m in own:
                setattr(obj, m, own[m])
            else:
                delattr(obj, m)
