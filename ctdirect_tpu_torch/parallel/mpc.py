"""Batched receding-horizon MPC controller (PyTorch port of
`ctdirect_tpu.parallel.mpc`).

Per tick, every batched instance gets its measured state x0 injected through
the boundary-constraint right-hand sides, the previous optimal state is
SHIFTED one step (the classic MPC warm start), and a fixed-iteration resolve
(solver/resolve.py) returns the new plan. The tick is `torch.func.vmap` of the
single-instance tick; inside it, each Newton step's block solve reaches the
batched CR (the hand-written CUDA kernel on the card) once for the whole
batch through the dispatch in solver/lanes.py.

On a CUDA device the tick runs as the JAX package runs `jax.jit(vtick)`: one
compiled program per input signature. Here that is a CUDA graph
(`solver/graph.py::CallGraph`) captured at the first call of each signature
and replayed after, so a tick is a few input copies, one graph launch and a
few output copies instead of thousands of launches issued from Python. The
arithmetic is the eager tick's; `MPCController.eager` runs that un-graphed
tick on any device.

Sharded ticks (SPMD, one process per rank; parallel/spmd.py launches such
worlds): with `mesh` and `batch_axis`, rank i of the batch axis holds and
ticks rows [i B/D, (i+1) B/D) of the global batch, with no collective on the
hot path. With a `time_axis` too (the 2-D batch x time mesh), the state is
replicated over the time axis: every rank of a time group ticks the same
rows, and only the KKT block solve is distributed over that group
(parallel/time_shard.py::InsideTimeShardKKT). Over NCCL (one card per
rank) its halos, all_reduce and all_gathers are captured in the tick's
graph as the JAX package's shard_map'd tick holds its collectives."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from ctdirect_tpu_torch.parallel.time_shard import InsideTimeShardKKT, ShardAxis
from ctdirect_tpu_torch.solver.graph import CallGraph, graph_counters, kkt_capturable, signature
from ctdirect_tpu_torch.solver.ipm import IPMOptions, make_spec
from ctdirect_tpu_torch.solver.resolve import (
    WarmState,
    make_resolver,
    push_inside,
    warm_state_from_result,
)
from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT
from ctdirect_tpu_torch.transcription.docp import DOCP


def shift_state(docp: DOCP, st: WarmState) -> WarmState:
    """Shift the plan one step forward (duplicate the last step) — the MPC
    warm start between consecutive horizons."""

    def shift_z(z):
        V = docp.unpack(z)
        X = torch.cat([V.X[1:], V.X[-1:]], dim=0)
        U = torch.cat([V.U[1:], V.U[-1:]], dim=0)
        K = None
        if V.K is not None:
            K = torch.cat([V.K[1:], V.K[-1:]], dim=0)
        return docp.pack(X, U, K, V.v)

    def shift_rows(arr, width):
        rows = arr[: docp.N * width].reshape(docp.N, width)
        shifted = torch.cat([rows[1:], rows[-1:]], dim=0)
        return torch.cat([shifted.reshape(-1), arr[docp.N * width :]])

    return WarmState(
        z=shift_z(st.z),
        s=shift_rows(st.s, docp.cw),
        lam=shift_rows(st.lam, docp.cw),
        wL=shift_rows(st.wL, docp.bw),
        wU=shift_rows(st.wU, docp.bw),
        yL=shift_rows(st.yL, docp.cw),
        yU=shift_rows(st.yU, docp.cw),
    )


class MPCController:
    """Batched MPC loop over one DOCP structure, on one device or on a rank
    of a mesh.

    The initial-state boundary rows to retarget are located via
    `x0_boundary_rows`: indices (into the boundary-constraint rows) holding the
    equality x(t0) == x0, in state-component order. `device` and `dtype` must
    match the DOCP's.

    How a tick runs (`__call__`):
    - on the CPU, eagerly, as the tests run it;
    - on a CUDA device, single-device, as a rank of a batch-only mesh, or
      with a `time_axis` over NCCL (the 2-D batch x time mesh, one card per
      rank), as a replay of a CUDA graph (`CallGraph`), captured at the first
      call of each input signature (B, dtypes, shapes) and kept in `graphs`;
      `captures` counts the captures and `graphed` says whether ticks
      replay. The first call of a signature runs one eager warm-up tick
      (which also makes the time axis's NCCL communicators), captures, then
      replays. Every rank of a time group captures and replays the same
      graph in the same order, so their collectives meet;
    - with a `time_axis` over gloo (ranks sharing a card, or CPU ranks),
      eagerly: gloo stages CUDA messages through host memory
      (parallel/time_shard.py), which a graph cannot capture. That is a
      deviation from the JAX package, whose 2-D tick is jitted as well.

    `eager` runs the un-graphed tick on any device, the counterpart of the
    un-jitted `vtick`; the graph is held against it."""

    def __init__(
        self,
        docp: DOCP,
        x0_boundary_rows,
        resolve_iters: int = 3,
        mu: float = 1e-6,
        shift: bool = True,
        kkt_algorithm: str = "scan",
        kkt_solve_dtype: Optional[torch.dtype] = None,
        kkt_equilibrate: bool = False,
        kkt_assemble_dtype: Optional[torch.dtype] = None,
        mesh=None,
        batch_axis: str = "batch",
        time_axis: Optional[str] = None,
        kkt_factory=None,
        *,
        device,
        dtype: torch.dtype = torch.float64,
    ):
        """kkt_solve_dtype=torch.float32 runs the block solve in f32 inside
        the f64 Newton loop (the bench configuration); kkt_assemble_dtype=
        torch.float32 also runs the operator's prepare and assembly in f32
        while the Newton residuals stay in the DOCP's dtype.

        mesh + batch_axis: this rank ticks its own rows of the batch
        (data-parallel tick); the caller passes and gets back those rows.
        mesh + batch_axis + time_axis: 2-D mesh; each instance's KKT chain is
        solved by the distributed CR over time_axis, the rest replicated
        over it. kkt_factory(docp) -> KKT operator overrides the default
        construction (first the factory, then InsideTimeShardKKT with a
        time_axis, else StructuredKKT)."""
        if time_axis is not None and mesh is None:
            raise ValueError("time_axis= needs a mesh")
        device = torch.device(device)
        if device != docp.device or dtype != docp.dtype:
            raise ValueError(
                f"MPCController on {device}/{dtype} but the DOCP is on {docp.device}/{docp.dtype}"
            )
        self.docp = docp
        self.device, self.dtype = device, dtype
        self.shift = shift
        spec = self._spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        self.axis = None if mesh is None else ShardAxis(mesh, batch_axis)
        if kkt_factory is not None:
            self.kkt = kkt_factory(docp)
        elif time_axis is not None:
            taxis = ShardAxis(mesh, time_axis)
            self.kkt = InsideTimeShardKKT(docp, taxis, taxis.size, solve_dtype=kkt_solve_dtype)
        else:
            # equilibration default OFF on the tick: the warm resolve is
            # mildly conditioned by construction
            self.kkt = StructuredKKT(
                docp,
                algorithm=kkt_algorithm,
                solve_dtype=kkt_solve_dtype,
                equilibrate=kkt_equilibrate,
                assemble_dtype=kkt_assemble_dtype,
            )
        resolve = make_resolver(
            docp.nlp_objective,
            docp.constraints,
            spec,
            self.kkt,
            device=device,
            iters=resolve_iters,
            mu=mu,
        )
        rows = torch.as_tensor(
            docp.boundary_row_indices()[np.asarray(x0_boundary_rows)], device=device
        )
        cl0 = docp.tensor(docp._c_lb)
        cu0 = docp.tensor(docp._c_ub)
        zl = docp.tensor(docp._z_lb)
        zu = docp.tensor(docp._z_ub)

        def tick(st: WarmState, x0):
            cl = cl0.index_put((rows,), x0)
            cu = cu0.index_put((rows,), x0)
            if shift:
                st = shift_state(docp, st)
            res = resolve(st, zl, zu, cl, cu)
            V = docp.unpack(res.state.z)
            u0 = docp.scheme.node_controls(V.U)[0]
            return res.state, u0, res.kkt_error, res.constraints_violation

        self._tick = vmap(tick)
        self.graphed = device.type == "cuda" and kkt_capturable(self.kkt)
        self.graphs = {}
        self.captures = 0
        # the plain-int counters a tick moves (a replay adds what its capture added)
        self._counters = graph_counters(self.kkt)

    def __call__(self, states: WarmState, x0_batch):
        """Advance all controllers one tick. states: batched WarmState;
        x0_batch: (B, len(rows)) (under a mesh: this rank's rows). Returns
        (new_states, u0, kkt_err, viol), tensors of the caller's own."""
        if not self.graphed:
            return self._tick(states, x0_batch)
        key = signature((states, x0_batch))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = CallGraph(self._tick, (states, x0_batch), self._counters)
            self.captures += 1
        return graph.replay((states, x0_batch))

    def eager(self, states: WarmState, x0_batch):
        """The tick run op by op, with no graph (same arguments and results
        as `__call__`)."""
        return self._tick(states, x0_batch)

    def cold_start(self, options: Optional[IPMOptions] = None, init=None) -> WarmState:
        """One full-IPM solve to seed the warm state (unbatched), moved
        strictly inside the boxes the tick's resolve uses (see
        `resolve.push_inside`)."""
        from ctdirect_tpu_torch.solver.interface import _get_solver

        docp = self.docp
        opts = options or IPMOptions(tol=1e-8)
        solver = _get_solver(docp, opts)
        z0 = docp.initial_guess(init)
        res, _post = solver(z0, docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        return push_inside(warm_state_from_result(res), self._spec, docp._z_lb, docp._z_ub,
                           docp._c_lb, docp._c_ub, opts.bound_relax_factor)


def broadcast_state(st: WarmState, batch: int) -> WarmState:
    """Tile an unbatched warm state across a batch axis."""
    return WarmState(*(a.expand((batch,) + a.shape).clone() for a in st))
