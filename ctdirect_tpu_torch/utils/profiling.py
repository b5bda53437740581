"""Lightweight timing / profiling helpers (PyTorch port of
`ctdirect_tpu.utils.profiling`): wall-clock timing with device
synchronization, and `torch.profiler` tracing into a Chrome trace."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

import torch

# the file `trace` writes into its logdir (chrome://tracing, Perfetto)
TRACE_FILE = "trace.json"


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
