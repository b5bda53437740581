"""Batched whole-IPM solves across problem instances (PyTorch port of
`ctdirect_tpu.parallel.batch`).

Each instance may have its own initial guess, its own constraint right-hand
sides (e.g. a per-instance initial state x0 through the boundary-constraint
bounds) and its own variable boxes; the batch axis maps over (z0, cl, cu, zl,
zu). The solve is `solver/ipm.py::ipm_solve_batched`: one batched IPM loop in
which converged instances keep their values while the others iterate, so the
batch completes when the slowest instance does. Every KKT solve of a loop trip
is one batched call; with `kkt_mode="cr"` on the card that is one launch of
the CR kernel for the whole batch.

Sharding (`mesh=`, `batch_axis=`): every rank of the world (SPMD, one
process per rank; parallel/spmd.py) is given the same global batch, solves
its own rows [i B/D, (i+1) B/D) (i its rank on the batch axis, D the axis
size) and hands back the global result, gathered with one all_gather per
output field at the end of the call: no collective inside the solve.

On a CUDA device the solve runs as the JAX package runs `jax.jit(vsolve)`:
compiled once per input signature. Here that is one CUDA graph per segment
of the batched IPM iteration (`solver/ipm.py::batched_ipm`), captured at the
segment's first use and replayed after (`BatchGraph`): the host still takes
every decision of the loops, one flag read per decision, but each stretch
between two reads is one graph launch instead of hundreds of launches
issued from Python. The arithmetic is the eager solve's, and
`BatchSolver.eager` runs that un-graphed solve on any device. Under a mesh
each rank graphs its own rows; the all_gather stays outside the graphs."""

from __future__ import annotations

import time
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves, tree_map

from ctdirect_tpu_torch.parallel.time_shard import ShardAxis
from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched
from ctdirect_tpu_torch.solver.interface import make_kkt
from ctdirect_tpu_torch.solver.ipm import BatchStats, IPMOptions, IPMResult, batched_ipm, make_spec
from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT
from ctdirect_tpu_torch.transcription.docp import DOCP


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
            with torch.cuda.graph(graph, pool=self.pool):
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


class BatchSolver:
    """Batched solver for one DOCP structure, on one device (or, with
    `mesh`, on every rank of its `batch_axis`).

    Call signature: solver(z0_batch, cl_batch, cu_batch, zl_batch, zu_batch)
    -> IPMResult with a leading batch axis on every field. Bounds default to
    the DOCP's static bounds broadcast across the batch.

    The KKT operator follows `options.kkt_mode` as `solve` does ("cr" is the
    cyclic-reduction StructuredKKT; the JAX package's BatchSolver passes no
    operator for "cr" and so solves it densely). `stats` counts the batched
    KKT solves, host reads, outer iterations and segment runs over all calls
    (of this rank's rows under a mesh). `device` and `dtype` must match the
    DOCP's. Under a mesh the batch must split evenly over the axis:
    ValueError otherwise, where the JAX package accepts an uneven split.

    How a solve runs (`__call__`):
    - on the CPU, eagerly, as the tests run it;
    - on a CUDA device, as replays of CUDA graphs (`BatchGraph`), one per
      segment, captured at each segment's first use for each batch size and
      kept in `graphs` (batch size -> BatchGraph); `captures` counts the
      segment graphs held. What a call returns stays valid after the next
      call. A capture or replay that fails raises and drops that batch
      size's graphs; nothing falls back to the eager solve.
    `eager` runs the un-graphed solve on any device, the counterpart of the
    un-jitted `vsolve`; the graphs are held against it."""

    def __init__(
        self,
        docp: DOCP,
        options: IPMOptions = IPMOptions(),
        mesh=None,
        batch_axis: str = "batch",
        kkt: Optional[object] = None,
        *,
        device,
        dtype: torch.dtype = torch.float64,
    ):
        self.axis = None if mesh is None else ShardAxis(mesh, batch_axis)
        device = torch.device(device)
        if device != docp.device or dtype != docp.dtype:
            raise ValueError(
                f"BatchSolver on {device}/{dtype} but the DOCP is on {docp.device}/{docp.dtype}"
            )
        self.docp = docp
        self.options = options
        self.device, self.dtype = device, dtype
        self.spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        self.kkt = make_kkt(docp, options) if kkt is None else kkt
        self.program = batched_ipm(docp.nlp_objective, docp.constraints, self.spec, options, self.kkt,
                                   device=device, dtype=dtype)
        self.stats = BatchStats()
        self.graphed = device.type == "cuda"
        self.graphs = {}
        # the plain-int counters a solve moves (a replay adds what its capture added)
        self._counters = [(cr_solve_batched, "launches"), (cr_solve_batched, "grid_launches")]
        if isinstance(self.kkt, StructuredKKT):
            self._counters.append((self.kkt, "block_solves"))

    @property
    def captures(self) -> int:
        return sum(len(g.graphs) for g in self.graphs.values())

    def __call__(self, z0_batch, cl_batch=None, cu_batch=None, zl_batch=None, zu_batch=None):
        """Every per-instance quantity may vary across the batch: the initial
        guess, the constraint rhs (cl/cu) and the variable boxes (zl/zu).
        Unsupplied bounds broadcast from the DOCP's static ones."""
        solve = self._replayed if self.graphed else self._eager
        return self._solve(solve, z0_batch, cl_batch, cu_batch, zl_batch, zu_batch)

    def eager(self, z0_batch, cl_batch=None, cu_batch=None, zl_batch=None, zu_batch=None):
        """The solve run op by op, with no graph (same arguments and results
        as `__call__`)."""
        return self._solve(self._eager, z0_batch, cl_batch, cu_batch, zl_batch, zu_batch)

    def _solve(self, solve, z0_batch, cl_batch, cu_batch, zl_batch, zu_batch):
        docp = self.docp
        z0 = docp.tensor(z0_batch)
        B = z0.shape[0]
        rows = slice(0, B)
        if self.axis is not None:
            D = self.axis.size
            if B % D:
                raise ValueError(f"a batch of {B} does not split over the {D} ranks of axis {self.axis.name!r}")
            rows = slice(self.axis.rank * (B // D), (self.axis.rank + 1) * (B // D))
            z0 = z0[rows]

        def bc(given, default):
            if given is not None:
                return docp.tensor(given)[rows]
            default = docp.tensor(default)
            return default.expand((z0.shape[0],) + default.shape)

        res = solve(z0, bc(zl_batch, docp._z_lb), bc(zu_batch, docp._z_ub), bc(cl_batch, docp._c_lb),
                    bc(cu_batch, docp._c_ub))
        if self.axis is None:
            return res
        return IPMResult(*(self._gather(x) for x in res))

    def _eager(self, z0, zl, zu, cl, cu):
        return self.program.eager(z0, zl, zu, cl, cu, self.stats)

    def _replayed(self, z0, zl, zu, cl, cu):
        prog = self.program
        state = prog.setup(z0, zl, zu, cl, cu, self.stats)
        key = z0.shape[0]
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = BatchGraph(prog.segments, self._counters, self.device)
        try:
            graph.load(state)
            prog.drive(graph.state, graph.run, self.stats)
        except BaseException:
            del self.graphs[key]
            raise
        # the epilogue reads the persistent state, which the next call overwrites
        return IPMResult(*(x.clone() for x in prog.epilogue(graph.state)))

    def _gather(self, x):
        # bool tensors travel as uint8
        if x.dtype == torch.bool:
            return self.axis.all_gather(x.to(torch.uint8)).to(torch.bool)
        return self.axis.all_gather(x)


def make_batch_solver(docp, options=IPMOptions(), mesh=None, kkt=None, *, batch_axis: str = "batch", device,
                      dtype: torch.dtype = torch.float64) -> BatchSolver:
    return BatchSolver(docp, options=options, mesh=mesh, batch_axis=batch_axis, kkt=kkt, device=device,
                       dtype=dtype)
