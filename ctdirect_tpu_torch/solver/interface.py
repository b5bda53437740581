"""High-level solve API (PyTorch port of `ctdirect_tpu.solver.interface`).

`solve(ocp, ..., device=...)` is the front door: transcribe + solve + build
Solution. The solver, with its KKT operator, is cached per (DOCP, options):
the JAX package caches `jax.jit(run)` there, and on a CUDA device the port
caches the CUDA graphs of its compiled solve there (`DOCPSolver`)."""

from __future__ import annotations

from typing import Optional

import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import OCP
from ctdirect_tpu_torch.model.solution import Solution
from ctdirect_tpu_torch.solver.graph import BatchGraph, graph_counters, kkt_capturable
from ctdirect_tpu_torch.solver.ipm import (
    STATUS_MESSAGES,
    BatchStats,
    IPMOptions,
    IPMResult,
    batched_ipm,
    ipm_solve,
    make_spec,
)
from ctdirect_tpu_torch.transcription.docp import DOCP, transcribe


def make_kkt(docp: DOCP, options: IPMOptions):
    """The KKT operator `options.kkt_mode` asks for: None for "dense" (the
    solvers default to DenseKKT), a StructuredKKT with the scan solve for
    "structured" and with the cyclic-reduction solve for "cr"."""
    if options.kkt_mode == "dense":
        return None
    if options.kkt_mode not in ("structured", "cr"):
        raise ValueError(f"unknown kkt_mode {options.kkt_mode!r}")
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    sdt = torch.float32 if options.kkt_solve_dtype in ("f32", "float32") else None
    return StructuredKKT(
        docp,
        algorithm="cr" if options.kkt_mode == "cr" else "scan",
        solve_dtype=sdt,
        refine=options.kkt_refine if sdt is not None else 0,
        equilibrate=options.kkt_equilibrate,
    )


class DOCPSolver:
    """The solve of one DOCP under one set of options, on the DOCP's device:
    run(z0, zl, zu, cl, cu) -> (IPMResult, the postprocess tuple (X, u, v,
    t)). It is the counterpart of the JAX package's `jax.jit(run)`
    (`ctdirect_tpu/solver/interface.py`).

    - On a CUDA device a call runs the batched IPM at B=1
      (`solver/ipm.py::batched_ipm`, the program `BatchSolver` runs): the
      inputs get a batch axis of 1, the set-up runs eagerly (its
      least-squares multiplier init included), each segment of the
      iteration is a CUDA graph (`solver/graph.py::BatchGraph`, captured at
      the segment's first use, warm-up on a side stream, then replayed),
      and the result is cloned out of the persistent state and stripped of
      its batch axis, with `iterations`, `status` and `successful` as the
      Python values `ipm_solve` returns. The graphs are kept here (`graph`,
      `graphs`, `captures`), so a second solve of the same DOCP replays
      them and they go with the DOCP. A capture or replay that fails raises
      and drops them; nothing falls back to the eager solve. `stats` counts
      the compiled solves' KKT solves, host reads, iterations and segment
      runs (`BatchStats`).
    - `eager(...)` is `ipm_solve`, op by op, on any device: the counterpart
      of the un-jitted `run`. On the CPU, and with `options.debug` on any
      device (its per-iteration print reads the device; the JAX package
      prints from inside its jit with `jax.debug.print`), a call is `eager`.

    The batched program follows `ipm_solve`'s iterates bit for bit under
    the "cr" and "dense" solves in f64 and under an f32 block solve with
    refinement and Ruiz scaling where no refinement residual differs; under
    the structured scan and in the refinement residual (`_block_matvec`'s
    einsums reduce in another order under vmap) they agree to rounding.

    `kkt` is the KKT operator both forms use: the one passed, else the one
    `options.kkt_mode` asks for (None for "dense"); its `block_solves` also
    counts the real block solves of the segments' warm-ups in a first call,
    which `warmup_block_solves` sums.

    The time-sharded solve is `DOCPSolver(docp, options,
    kkt=TimeShardedKKT(docp, mesh))`, called on every rank of the mesh's
    time axis with the same arguments: the counterpart of the JAX package's
    `ipm_solve(kkt=TimeShardedKKT)` inside its jitted `while_loop`. Over
    NCCL on a card it is compiled, the distributed CR's messages and the CR
    kernel's root solve inside the segment graphs; every rank reads its own
    flags, which agree because the sharded solve hands every rank the same
    bytes. Over gloo (messages staged through the host) a call is
    `eager`."""

    def __init__(self, docp: DOCP, options: IPMOptions, kkt=None):
        self.docp = docp
        self.options = options
        self.spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        self.kkt = make_kkt(docp, options) if kkt is None else kkt
        self.graphed = docp.device.type == "cuda" and not options.debug and kkt_capturable(self.kkt)
        self.stats = BatchStats()
        self.graph = None  # the BatchGraph of the compiled solve, made at its first call
        self.program = batched_ipm(docp.nlp_objective, docp.constraints, self.spec, options, self.kkt,
                                   device=docp.device, dtype=docp.dtype)

    @property
    def graphs(self) -> dict:
        """Segment name -> its captured graph (and what a replay counts)."""
        return {} if self.graph is None else self.graph.graphs

    @property
    def captures(self) -> int:
        return len(self.graphs)

    @property
    def capture_s(self) -> float:
        """The seconds spent capturing the graphs it holds."""
        return 0.0 if self.graph is None else self.graph.capture_s

    @property
    def warmup_block_solves(self) -> int:
        """The block solves of the segments' warm-ups so far (real solves,
        run once per segment before its capture)."""
        if self.graph is None or self.kkt is None:
            return 0
        return self.graph.warmup_added[self.kkt, "block_solves"]

    def __call__(self, z0, zl, zu, cl, cu):
        if not self.graphed:
            return self.eager(z0, zl, zu, cl, cu)
        if self.graph is None:
            self.graph = BatchGraph(self.program.segments, graph_counters(self.kkt), self.docp.device)
        try:
            return self.batched(self.graph, z0, zl, zu, cl, cu)
        except BaseException:
            self.graph = None
            raise

    def batched(self, graph, z0, zl, zu, cl, cu):
        """The B=1 program through `graph`, a BatchGraph of its segments
        (`BatchGraph(..., capture=False)` runs it op by op, on any device),
        returned as the eager solve returns its result."""
        docp = self.docp
        res = graph.solve(self.program, self.stats, *(docp.tensor(x)[None] for x in (z0, zl, zu, cl, cu)))
        res = IPMResult(*(x[0] for x in res))
        iterations, status = torch.stack([res.iterations, res.status]).tolist()
        result = res._replace(iterations=iterations, status=status, successful=status in (0, 4))
        return result, docp.postprocess(result.z)

    def eager(self, z0, zl, zu, cl, cu):
        """The solve run op by op (`ipm_solve`), on any device."""
        docp = self.docp
        result = ipm_solve(docp.nlp_objective, docp.constraints, self.spec, z0, zl, zu, cl, cu,
                           options=self.options, kkt=self.kkt, device=docp.device, dtype=docp.dtype)
        return result, docp.postprocess(result.z)


def _get_solver(docp: DOCP, options: IPMOptions) -> DOCPSolver:
    """The DOCPSolver of `docp` under `options`, cached on the DOCP until
    `docp.release_solvers()`."""
    cache = docp.__dict__.setdefault("_solver_cache", {})
    if options not in cache:
        cache[options] = DOCPSolver(docp, options)
    return cache[options]


def solve_docp(
    docp: DOCP,
    init: Optional[InitialGuess] = None,
    options: IPMOptions = IPMOptions(),
    display: bool = False,
) -> Solution:
    """Solve a transcribed DOCP (on its device) and map the result back to
    continuous time. With a structured KKT operator, `sol.infos
    ["kkt_block_solves"]` counts the block solves of this solve and
    `["kkt_warmup_block_solves"]` those of the warm-ups before its graphs'
    captures (on a CUDA device, in the first solve of a DOCP; 0 otherwise):
    with kkt_mode="cr" on the card their sum is the CR kernel's launches.
    A compiled solve also reports the segment graphs its solver holds
    (`["captures"]`) and the seconds this call spent capturing
    (`["capture_s"]`, 0 where it only replayed).

    The solver, and on a card its graphs, stay cached on the DOCP, so a
    second solve of it replays them; `docp.release_solvers()` frees them
    when the DOCP is done with."""
    if isinstance(init, Solution):
        init = InitialGuess.from_solution(init)
    z0 = docp.initial_guess(init)
    solver = _get_solver(docp, options)
    infos = {}
    if solver.kkt is not None:
        before, warm = solver.kkt.block_solves, solver.warmup_block_solves
    capture_s = solver.capture_s
    result, post = solver(z0, docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    if solver.kkt is not None:
        warm = solver.warmup_block_solves - warm
        infos = {"kkt_block_solves": solver.kkt.block_solves - before - warm, "kkt_warmup_block_solves": warm}
    if solver.graphed:
        infos.update(captures=solver.captures, capture_s=solver.capture_s - capture_s)
    sol = docp.build_solution(
        result, message=STATUS_MESSAGES.get(int(result.status), "Unknown"), infos=infos, post=post
    )
    if display:
        print(sol)
    return sol


def solve(
    ocp: OCP,
    grid_size: int = 250,
    scheme: str = "midpoint",
    time_grid=None,
    control_steps: int = 1,
    init: Optional[InitialGuess] = None,
    options: Optional[IPMOptions] = None,
    display: bool = False,
    *,
    device,
    dtype: torch.dtype = torch.float64,
    **opt_kwargs,
) -> Solution:
    """Transcribe and solve an OCP on `device` ("cpu", "cuda", ...) in `dtype`.
    On a CUDA device the solve is compiled (`DOCPSolver`): each call
    transcribes a new DOCP and so captures its graphs anew, as the JAX
    package's front door compiles anew.

    Defaults mirror the JAX package (grid_size=250, scheme="midpoint"). Extra
    keyword args are IPMOptions fields (tol=..., max_iter=..., ...)."""
    if options is None:
        options = IPMOptions(**opt_kwargs)
    elif opt_kwargs:
        options = options.replace(**opt_kwargs)
    docp = transcribe(
        ocp,
        grid_size=grid_size,
        scheme=scheme,
        time_grid=time_grid,
        control_steps=control_steps,
        device=device,
        dtype=dtype,
    )
    try:
        return solve_docp(docp, init=init, options=options, display=display)
    finally:
        docp.release_solvers()
