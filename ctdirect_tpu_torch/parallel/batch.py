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

from typing import Optional

import torch

from ctdirect_tpu_torch.parallel.time_shard import ShardAxis
from ctdirect_tpu_torch.solver.graph import BatchGraph, graph_counters, kkt_capturable
from ctdirect_tpu_torch.solver.interface import make_kkt
from ctdirect_tpu_torch.solver.ipm import BatchStats, IPMOptions, IPMResult, batched_ipm, make_spec
from ctdirect_tpu_torch.transcription.docp import DOCP


class BatchSolver:
    """Batched solver for one DOCP structure, on one device (or, with
    `mesh`, on every rank of its `batch_axis`).

    Call signature: solver(z0_batch, cl_batch, cu_batch, zl_batch, zu_batch)
    -> IPMResult with a leading batch axis on every field. Bounds default to
    the DOCP's static bounds broadcast across the batch.

    The KKT operator follows `options.kkt_mode` as `solve` does ("cr" is the
    cyclic-reduction StructuredKKT; the JAX package's BatchSolver passes no
    operator for "cr" and so solves it densely). Under "structured" it
    honours `kkt_solve_dtype`, `kkt_refine` and `kkt_equilibrate` as `solve`
    does (`make_kkt`), where the JAX package's BatchSolver builds the f64
    `StructuredKKT(docp)` whatever they say
    (`ctdirect_tpu/parallel/batch.py:53-56`): given `kkt_solve_dtype="f32"`
    the port's batch is the one with `StructuredKKT(solve_dtype=float32,
    refine=2)`, the JAX batch its f64 one
    (`tests/test_torch_batch_f32_options.py`). `stats` counts the batched
    KKT solves, host reads, outer iterations and segment runs over all calls
    (of this rank's rows under a mesh). `device` and `dtype` must match the
    DOCP's. Under a mesh the batch must split evenly over the axis:
    ValueError otherwise, where the JAX package accepts an uneven split.

    How a solve runs (`__call__`):
    - on the CPU, eagerly, as the tests run it;
    - on a CUDA device (with a KKT operator whose messages, if any, go over
      NCCL), as replays of CUDA graphs (`BatchGraph`), one per
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
        self.graphed = device.type == "cuda" and kkt_capturable(self.kkt)
        self.graphs = {}
        self._counters = graph_counters(self.kkt)

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
        key = z0.shape[0]
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = BatchGraph(self.program.segments, self._counters, self.device)
        try:
            return graph.solve(self.program, self.stats, z0, zl, zu, cl, cu)
        except BaseException:
            del self.graphs[key]
            raise

    def _gather(self, x):
        # bool tensors travel as uint8
        if x.dtype == torch.bool:
            return self.axis.all_gather(x.to(torch.uint8)).to(torch.bool)
        return self.axis.all_gather(x)


def make_batch_solver(docp, options=IPMOptions(), mesh=None, kkt=None, *, batch_axis: str = "batch", device,
                      dtype: torch.dtype = torch.float64) -> BatchSolver:
    return BatchSolver(docp, options=options, mesh=mesh, batch_axis=batch_axis, kkt=kkt, device=device,
                       dtype=dtype)
