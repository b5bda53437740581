"""CUDA graphs: the port's counterpart of `jax.jit`.

`BatchGraph` holds the segments of the batched IPM (`solver/ipm.py::
batched_ipm`), the compiled form of a solve: one solve's persistent state
and one graph per segment, captured at the segment's first use and replayed
as the host's flag reads order them. `BatchSolver` replays them for its
batch sizes (parallel/batch.py), and the unbatched solve of
`solver/interface.py` at B=1.

`CallGraph` holds one call of a function for one input signature: the MPC
tick (parallel/mpc.py) and the distributed CR (parallel/time_shard.py).

`result_diff` measures how far a compiled solve's result is from its eager
form's.

A KKT operator whose solve exchanges messages over a mesh axis (`kkt.axis`,
parallel/time_shard.py) can sit in a graph only over NCCL, which carries
CUDA tensors from card to card; gloo stages them through the host, which no
graph can hold (`kkt_capturable`)."""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched
from ctdirect_tpu_torch.solver.ipm import IPMResult
from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched
from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT


KERNEL_COUNTERS = ((cr_solve_batched, "launches"), (cr_solve_batched, "grid_launches"),
                   (scan_solve_batched, "launches"))


def graph_counters(kkt):
    """The plain-int counters a solve with the KKT operator `kkt` moves
    ((object, attribute) pairs; a replay adds what its capture added): the
    CR kernel's launches and CUDA launches, the scan kernel's launches, a
    structured operator's block solves, and a sharded operator's own
    (`kkt.counters`: its block solves and its axis's messages)."""
    counters = list(KERNEL_COUNTERS)
    if isinstance(kkt, StructuredKKT):
        counters.append((kkt, "block_solves"))
    counters += getattr(kkt, "counters", [])
    return counters


def kkt_capturable(kkt) -> bool:
    """Whether a solve with the KKT operator `kkt` can be captured: yes
    unless its messages go over a gloo axis (staged through the host)."""
    axis = getattr(kkt, "axis", None)
    return axis is None or axis.capturable


def signature(args) -> tuple:
    """What a captured call is specialised to: the shape, dtype and device
    of every tensor in `args` (a pytree)."""
    return tuple((tuple(a.shape), a.dtype, a.device) for a in tree_leaves(args))


@contextlib.contextmanager
def _no_collector():
    """No cyclic garbage collection inside a capture: collecting a dead
    solver there would destroy its graphs, which invalidates the capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def result_diff(a, b) -> float:
    """Max abs difference of two solves' results (sequences of tensors, such
    as two IPMResults) over every field and instance: inf where their NaNs
    or integer fields differ."""
    worst = 0.0
    for x, y in zip(a, b):
        if not x.is_floating_point():
            worst = max(worst, 0.0 if torch.equal(x, y) else float("inf"))
            continue
        if not torch.equal(torch.isnan(x), torch.isnan(y)):
            return float("inf")
        ok = ~torch.isnan(x)
        worst = max(worst, (x[ok] - y[ok]).abs().max().item() if ok.any() else 0.0)
    return worst


class CallGraph:
    """One call `fn(*args)` captured as a CUDA graph for one input signature.

    Capture follows `torch.cuda.graph`'s protocol: `fn` runs once on a side
    stream first, so that the first-use work (the CR kernel's build and
    load, lazily made tables, library handles, NCCL communicators) happens
    outside the capture; the kernel launches and messages of that warm-up
    are real and counted. The capture itself launches nothing, so the
    plain-int counters the call moves (`counters`: (object, attribute)
    pairs) are put back after it, and each replay adds what the capture
    added.

    `replay(args)` copies the caller's tensors into the graph's static
    inputs and returns clones of its static outputs (the same pytree),
    which the next replay overwrites: what a call returns stays valid after
    the next one, as a jitted function's fresh arrays do. A capture or
    replay that fails raises."""

    def __init__(self, fn, args, counters):
        device = tree_leaves(args)[0].device
        self.inputs = tree_map(lambda a: a.clone(), args)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = [getattr(obj, name) for obj, name in counters]
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with _no_collector(), torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
        finally:
            self.counts = [(obj, name, getattr(obj, name) - b) for (obj, name), b in zip(counters, before)]
            for (obj, name), b in zip(counters, before):
                setattr(obj, name, b)
        self.capture_s = time.perf_counter() - t0
        # the graph's private memory pool (its intermediates and outputs)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self, args):
        for dst, src in zip(tree_leaves(self.inputs), tree_leaves(args)):
            dst.copy_(src)
        self.graph.replay()
        for obj, name, added in self.counts:
            setattr(obj, name, getattr(obj, name) + added)
        return tree_map(lambda a: a.clone(), self.outputs)


class BatchGraph:
    """The segments of one batched solve captured as CUDA graphs, for one
    input signature (the batch size B; all else is fixed per solver).

    `state` holds the solve's persistent tensors, the only way data passes
    between segments: `load` copies a solve's set-up into them and `run(name)`
    replays segment `name`, whose graph computes the segment from `state` and
    copies what it returns back into `state` (its commit). No graph reads
    another's outputs, so all share one memory pool and replay in any order,
    as the host's decisions order them.

    A segment is captured at its first use, following `torch.cuda.graph`'s
    protocol: its body runs once on a side stream first (into scratch
    outputs, which size the state entries it adds), so that first-use work
    such as the CR kernel's build and load happens outside the capture; the
    kernel launches of that warm-up are real and counted, and `warmup_added`
    sums what the warm-ups added to each counter. The capture itself
    launches nothing, so the plain-int counters a segment moves (`counters`:
    (object, attribute) pairs) are put back after it, and each replay adds
    what the capture added. A capture or replay that fails raises.

    capture=False runs each segment's body and commit op by op instead of a
    graph: the persistent-state path on a device without graphs (the CPU
    tests run it)."""

    def __init__(self, segments, counters, device, capture: bool = True):
        self.segments = segments
        self.counters = counters
        self.device = torch.device(device)
        self.capture = capture
        self.state = {}
        self.graphs = {}  # segment name -> (CUDA graph, what one replay adds to each counter)
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.capture_s = 0.0
        self.pool_bytes = 0  # the graphs' shared pool (their intermediates and outputs)
        self.warmup_added = dict.fromkeys(counters, 0)

    def load(self, state):
        """Copy a solve's starting state into the persistent tensors (made at
        the first load, outside any capture)."""
        for key, value in state.items():
            if key in self.state:
                self._copy(key, value)
            else:
                self.state[key] = tree_map(lambda x: x.clone(), value)

    def _copy(self, key, value):
        for dst, src in zip(tree_leaves(self.state[key]), tree_leaves(value)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise RuntimeError(f"state entry {key!r}: {tuple(src.shape)} {src.dtype} does not fit "
                                   f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

    def _add_entries(self, out):
        """Persistent tensors for the entries `out` adds to the state."""
        for key, value in out.items():
            if key not in self.state:
                self.state[key] = tree_map(torch.empty_like, value)

    def _commit(self, out):
        for key, value in out.items():
            self._copy(key, value)

    def _counts(self):
        return [getattr(obj, name) for obj, name in self.counters]

    def _capture(self, name):
        fn = self.segments[name]
        device = self.device
        before = self._counts()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            scratch = fn(self.state)
        torch.cuda.current_stream(device).wait_stream(side)
        for counter, a, b in zip(self.counters, self._counts(), before):
            self.warmup_added[counter] += a - b
        self._add_entries(scratch)
        del scratch
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        before = self._counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with _no_collector(), torch.cuda.graph(graph, pool=self.pool):
                self._commit(fn(self.state))
        finally:
            added = [a - b for a, b in zip(self._counts(), before)]
            for (obj, attr), b in zip(self.counters, before):
                setattr(obj, attr, b)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(device) - reserved
        self.graphs[name] = (graph, added)

    def run(self, name):
        """Segment `name` on `state`: a replay of its graph (captured first
        at the segment's first use)."""
        if not self.capture:
            out = self.segments[name](self.state)
            self._add_entries(out)
            self._commit(out)
            return
        if name not in self.graphs:
            self._capture(name)
        graph, added = self.graphs[name]
        graph.replay()
        for (obj, attr), a in zip(self.counters, added):
            setattr(obj, attr, getattr(obj, attr) + a)

    def solve(self, program, stats, z0, zl, zu, cl, cu) -> IPMResult:
        """One solve of `program` (a `batched_ipm`) through these graphs:
        its set-up, loaded into the persistent state, then the host's loops
        with every segment replayed, then the result, cloned out of the state
        (which the next solve overwrites)."""
        self.load(program.setup(z0, zl, zu, cl, cu, stats))
        program.drive(self.state, self.run, stats)
        return IPMResult(*(x.clone() for x in program.epilogue(self.state)))
