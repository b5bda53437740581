"""DOCP: the transcribed finite-dimensional NLP (PyTorch port of
`ctdirect_tpu.transcription.docp`).

Canonical flat variable layout (step-major):

    [ w_1 | w_2 | ... | w_N | tail | v ]
    w_i  = [x_i | u-block_i | K_i^1 .. K_i^s]          (step block, width `bw`)
    tail = [x_{N+1}]  (+ [u_{N+1}] for trapeze)

Canonical constraint layout:

    [ defect_i (n) | stage eqs_i (s*n) | path_i (n_path) ] x N,
    then final-node path (n_path), then boundary (n_boundary).

Defect/stage rows are equalities with lb = ub = 0. Free t0/tf: the grid is
stored normalized in [0,1]; the real grid t = t0(v) + s*(tf(v) - t0(v)) is
recomputed from v on every evaluation.

The NLP callbacks (`objective`, `constraints`, ...) are torch functions of the
flat variable vector z on `self.device` in `self.dtype`; they are traceable by
`torch.func` transforms, so the solvers differentiate and batch them. Bounds,
index maps and the initial guess are host-side numpy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import OCP
from ctdirect_tpu_torch.model.solution import Solution
from ctdirect_tpu_torch.transcription.schemes import GenericIRK, OCPFns, Scheme, get_scheme, host_constant


class Variables(NamedTuple):
    """Unpacked DOCP variables."""

    X: torch.Tensor  # (N+1, n)
    U: torch.Tensor  # (Nu, cs, m)
    K: Optional[torch.Tensor]  # (N, s, n) or None
    v: torch.Tensor  # (q,)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _shaped(val, shape, like: torch.Tensor, consts: dict) -> torch.Tensor:
    """A user callable's output as a tensor of `shape`. A constant (a number
    or an array of numbers) becomes a tensor in `like`'s dtype and on its
    device once, at its first use, and is kept in `consts` by value, dtype and
    device: a host-to-device copy on every call would be a hidden sync in an
    eager tick and cannot be captured in a CUDA graph (the graphed tick's
    warm-up makes it before the capture)."""
    if not isinstance(val, torch.Tensor):
        arr = np.asarray(val, dtype=np.float64)
        key = (arr.shape, arr.tobytes(), like.dtype, like.device)
        if key not in consts:
            consts[key] = host_constant(arr, like)
        val = consts[key]
    return val.reshape(shape)


class DOCP:
    """Transcribed NLP over a fixed grid with a fixed scheme. Static config object;
    its methods are pure torch functions of the flat variable vector z."""

    def __init__(
        self,
        ocp: OCP,
        grid_size: int = 250,
        scheme: str = "midpoint",
        time_grid: Optional[np.ndarray] = None,
        control_steps: int = 1,
        *,
        device,
        dtype: torch.dtype = torch.float64,
    ):
        self.ocp = ocp
        self.device = torch.device(device)
        self.dtype = dtype
        self.scheme: Scheme = get_scheme(scheme, control_steps)
        n, m, q = ocp.n, ocp.m, ocp.q
        s, cs = self.scheme.stages, self.scheme.cs

        # ---- time grid (validation & normalization) ----
        if time_grid is not None:
            grid = np.asarray(time_grid, dtype=np.float64).ravel()
            if len(grid) < 2 or np.any(np.diff(grid) <= 0):
                raise ValueError("time_grid must be strictly increasing, length >= 2")
            N = len(grid) - 1
            if ocp.time.fixed:
                t0, tf = ocp.time.t0, ocp.time.tf
                if not (np.isclose(grid[0], t0) and np.isclose(grid[-1], tf)):
                    raise ValueError(
                        f"time_grid endpoints ({grid[0]}, {grid[-1]}) must match "
                        f"fixed (t0, tf) = ({t0}, {tf})"
                    )
                self._snorm = (grid - grid[0]) / (grid[-1] - grid[0])
                self._fixed_grid = grid
            else:
                self._snorm = (grid - grid[0]) / (grid[-1] - grid[0])
                self._fixed_grid = None
        else:
            N = int(grid_size)
            if N < 1:
                raise ValueError("grid_size must be >= 1")
            self._snorm = np.linspace(0.0, 1.0, N + 1)
            if ocp.time.fixed:
                t0, tf = ocp.time.t0, ocp.time.tf
                self._fixed_grid = t0 + self._snorm * (tf - t0)
            else:
                self._fixed_grid = None
        # device copies, made once (the callbacks run inside batched ticks)
        self._snorm_t = self.tensor(self._snorm)
        self._fixed_grid_t = None if self._fixed_grid is None else self.tensor(self._fixed_grid)
        if isinstance(self.scheme, GenericIRK):
            self.scheme._tableau(self._snorm_t)  # the Butcher tableau on this device, in this dtype

        self.N = N
        self.n, self.m, self.q = n, m, q
        self.s, self.cs = s, cs
        self.Nu = self.scheme.u_rows(N)

        # ---- flat layout ----
        self.bw = n + cs * m + s * n  # step block width
        self.tail_w = n + (m if self.scheme.u_at_nodes else 0)
        self.nz = N * self.bw + self.tail_w + q

        npath, nbound = ocp.n_path, ocp.n_boundary
        self.n_path, self.n_boundary = npath, nbound
        self.cw = n + s * n + npath  # per-step constraint block width
        self.nc = N * self.cw + npath + nbound

        # ---- wrapped callables (shape-normalized) ----
        consts = self._consts = {}

        def dyn(t, x, u, v):
            return _shaped(ocp.dynamics(t, x, u, v), (n,), x, consts)

        lag = None
        if ocp.has_lagrange:

            def lag(t, x, u, v):
                return _shaped(ocp.lagrange(t, x, u, v), (), x, consts)

        self.fns = OCPFns(dynamics=dyn, lagrange=lag)

        self._path = None
        if ocp.path is not None:

            def path(t, x, u, v):
                return _shaped(ocp.path(t, x, u, v), (npath,), x, consts)

            self._path = path

        self._boundary = None
        if ocp.boundary is not None:

            def boundary(x0, xf, v):
                return _shaped(ocp.boundary(x0, xf, v), (nbound,), x0, consts)

            self._boundary = boundary

        self._mayer = None
        if ocp.has_mayer:

            def mayer(x0, xf, v):
                return _shaped(ocp.mayer(x0, xf, v), (), x0, consts)

            self._mayer = mayer

        # ---- static bounds ----
        self._z_lb, self._z_ub = self._build_z_bounds()
        self._c_lb, self._c_ub = self._build_c_bounds()

    def tensor(self, x) -> torch.Tensor:
        """x as a tensor on this DOCP's device, in its dtype."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def release_solvers(self):
        """Drop the solvers that `solve_docp` cached on this DOCP (one per
        options), with what they hold: on a CUDA device, their segment
        graphs and the graphs' memory pool. A solver refers to its DOCP, so
        until this is called the two are freed only by Python's cycle
        collector. `ct.solve` and the continuations call it on the DOCPs
        they make; a caller of `solve_docp` calls it when done with the
        DOCP. A later `solve_docp` builds (and on a card captures) anew."""
        self.__dict__.pop("_solver_cache", None)

    # ------------------------------------------------------------------
    # time grid
    # ------------------------------------------------------------------
    def time_grid(self, v) -> torch.Tensor:
        """Real time grid (N+1,) — recomputed from v for free-time problems."""
        if self._fixed_grid_t is not None:
            return self._fixed_grid_t
        ts = self.ocp.time
        t0 = ts.t0 if not ts.free_t0 else v[ts.t0_index]
        tf = ts.tf if not ts.free_tf else v[ts.tf_index]
        return t0 + self._snorm_t * (tf - t0)

    def time_grid_np(self, v) -> np.ndarray:
        """Host (numpy) twin of time_grid, for the host-side initial guess."""
        if self._fixed_grid is not None:
            return np.asarray(self._fixed_grid)
        ts = self.ocp.time
        v = np.asarray(v)
        t0 = ts.t0 if not ts.free_t0 else float(v[ts.t0_index])
        tf = ts.tf if not ts.free_tf else float(v[ts.tf_index])
        return t0 + self._snorm * (tf - t0)

    # ------------------------------------------------------------------
    # pack / unpack (pure reshapes & slices)
    # ------------------------------------------------------------------
    def unpack(self, z) -> Variables:
        N, n, m, q, s, cs, bw = self.N, self.n, self.m, self.q, self.s, self.cs, self.bw
        steps = z[: N * bw].reshape(N, bw)
        tail = z[N * bw : N * bw + self.tail_w]
        v = z[self.nz - q : self.nz]
        X = torch.cat([steps[:, :n], tail[None, :n]], dim=0)
        if self.scheme.u_at_nodes:  # trapeze
            U = torch.cat(
                [steps[:, n : n + m].reshape(N, 1, m), tail[None, None, n : n + m]], dim=0
            )
        else:
            U = steps[:, n : n + cs * m].reshape(N, cs, m)
        K = steps[:, n + cs * m :].reshape(N, s, n) if s > 0 else None
        return Variables(X=X, U=U, K=K, v=v)

    def pack(self, X, U, K=None, v=None) -> torch.Tensor:
        N, n, m, q, s, cs = self.N, self.n, self.m, self.q, self.s, self.cs
        X = X.reshape(N + 1, n)
        U = U.reshape(self.Nu, cs, m)
        parts = [X[:-1]]
        if self.scheme.u_at_nodes:
            parts.append(U[:-1, 0, :])
        else:
            parts.append(U.reshape(N, cs * m))
        if s > 0:
            parts.append(K.reshape(N, s * n))
        steps = torch.cat(parts, dim=1).reshape(N * self.bw)
        tail = [X[-1]]
        if self.scheme.u_at_nodes:
            tail.append(U[-1, 0, :])
        pieces = [steps] + tail
        if q > 0:
            pieces.append(v.reshape(q))
        return torch.cat(pieces)

    # ------------------------------------------------------------------
    # NLP callbacks
    # ------------------------------------------------------------------
    def objective(self, z) -> torch.Tensor:
        """User-sense objective (Mayer + Lagrange quadrature)."""
        V = self.unpack(z)
        t = self.time_grid(V.v)
        h = t[1:] - t[:-1]
        obj = torch.zeros((), dtype=z.dtype, device=z.device)
        if self._mayer is not None:
            obj = obj + self._mayer(V.X[0], V.X[-1], V.v)
        if self.fns.lagrange is not None:
            obj = obj + self.scheme.quadrature(self.fns, V.X, V.U, V.K, t, h, V.v)
        return obj

    def nlp_objective(self, z) -> torch.Tensor:
        """Minimized objective (sign-flipped for max problems)."""
        obj = self.objective(z)
        return -obj if self.ocp.maximize else obj

    def constraints(self, z) -> torch.Tensor:
        """Full residual vector in the canonical constraint layout."""
        V = self.unpack(z)
        t = self.time_grid(V.v)
        h = t[1:] - t[:-1]
        N, n, s = self.N, self.n, self.s

        D, S = self.scheme.defects(self.fns, V.X, V.U, V.K, t, h, V.v)
        per_step = [D]
        if s > 0:
            per_step.append(S.reshape(N, s * n))

        if self._path is not None:
            u_nodes = self.scheme.node_controls(V.U)  # (N+1, m)
            P = vmap(self._path, in_dims=(0, 0, 0, None))(t, V.X, u_nodes, V.v)
            per_step.append(P[:-1])
            tail = [P[-1]]
        else:
            tail = []

        c = torch.cat(per_step, dim=1).reshape(N * self.cw)
        if self._boundary is not None:
            tail.append(self._boundary(V.X[0], V.X[-1], V.v))
        if tail:
            c = torch.cat([c] + tail)
        return c

    # ------------------------------------------------------------------
    # bounds (host numpy)
    # ------------------------------------------------------------------
    def _build_z_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        ocp = self.ocp
        N, n, q, s, cs = self.N, self.n, self.q, self.s, self.cs
        inf = np.inf

        def step_bounds(x_b, u_b, fill):
            parts = [x_b, np.tile(u_b, cs)]
            if s > 0:
                parts.append(np.full(s * n, fill))
            return np.concatenate(parts)

        lb_step = step_bounds(ocp.x_lb, ocp.u_lb, -inf)
        ub_step = step_bounds(ocp.x_ub, ocp.u_ub, inf)
        lb = [np.tile(lb_step, N), ocp.x_lb]
        ub = [np.tile(ub_step, N), ocp.x_ub]
        if self.scheme.u_at_nodes:
            lb.append(ocp.u_lb)
            ub.append(ocp.u_ub)
        if q > 0:
            lb.append(ocp.v_lb)
            ub.append(ocp.v_ub)
        return np.concatenate(lb), np.concatenate(ub)

    def _build_c_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        ocp = self.ocp
        N, n, s, npath = self.N, self.n, self.s, self.n_path
        step_lb = [np.zeros(n + s * n)]
        step_ub = [np.zeros(n + s * n)]
        if npath > 0:
            step_lb.append(ocp.path_lb)
            step_ub.append(ocp.path_ub)
        lb = [np.tile(np.concatenate(step_lb), N)]
        ub = [np.tile(np.concatenate(step_ub), N)]
        if npath > 0:
            lb.append(ocp.path_lb)
            ub.append(ocp.path_ub)
        if ocp.n_boundary > 0:
            lb.append(ocp.boundary_lb)
            ub.append(ocp.boundary_ub)
        return np.concatenate(lb), np.concatenate(ub)

    @property
    def z_bounds(self):
        return self._z_lb, self._z_ub

    @property
    def c_bounds(self):
        return self._c_lb, self._c_ub

    # ------------------------------------------------------------------
    # initial guess (host numpy)
    # ------------------------------------------------------------------
    def initial_guess(self, init: Optional[InitialGuess] = None) -> np.ndarray:
        """0.1-fill selectively overwritten by the user init. K stage variables
        always stay at the 0.1 default."""
        if init is None:
            init = InitialGuess()
        q = self.q
        v0 = init.eval_variable(q)
        t = self.time_grid_np(v0)
        h = t[1:] - t[:-1]
        X0 = init.eval_state(t, self.n)  # (N+1, n)
        ut = self.scheme.control_times(t, h)  # (Nu, cs)
        U0 = init.eval_control(ut.ravel(), self.m).reshape(self.Nu, self.cs, self.m)
        K0 = np.full((self.N, self.s, self.n), 0.1) if self.s > 0 else None
        return self._pack_np(X0, U0, K0, v0)

    def _pack_np(self, X, U, K=None, v=None) -> np.ndarray:
        """Host (numpy) twin of pack."""
        N, n, m, q, s, cs = self.N, self.n, self.m, self.q, self.s, self.cs
        X = np.asarray(X, dtype=np.float64).reshape(N + 1, n)
        U = np.asarray(U, dtype=np.float64).reshape(self.Nu, cs, m)
        parts = [X[:-1]]
        if self.scheme.u_at_nodes:
            parts.append(U[:-1, 0, :])
        else:
            parts.append(U.reshape(N, cs * m))
        if s > 0:
            parts.append(np.asarray(K, dtype=np.float64).reshape(N, s * n))
        steps = np.concatenate(parts, axis=1).reshape(N * self.bw)
        tail = [X[-1]]
        if self.scheme.u_at_nodes:
            tail.append(U[-1, 0, :])
        pieces = [steps] + tail
        if q > 0:
            pieces.append(np.asarray(v, dtype=np.float64).reshape(q))
        return np.concatenate(pieces)

    # ------------------------------------------------------------------
    # constraint-row index maps (for solution building / structured solver)
    # ------------------------------------------------------------------
    def defect_row_indices(self) -> np.ndarray:
        """(N, n) flat row indices of the defect rows (costate source)."""
        base = np.arange(self.N)[:, None] * self.cw
        return base + np.arange(self.n)[None, :]

    def path_row_indices(self) -> np.ndarray:
        """(N+1, n_path) flat row indices of the path-constraint rows."""
        if self.n_path == 0:
            return np.zeros((self.N + 1, 0), dtype=int)
        off = self.n + self.s * self.n
        base = np.arange(self.N)[:, None] * self.cw + off
        rows = base + np.arange(self.n_path)[None, :]
        final = self.N * self.cw + np.arange(self.n_path)
        return np.vstack([rows, final[None, :]])

    def boundary_row_indices(self) -> np.ndarray:
        start = self.N * self.cw + self.n_path
        return start + np.arange(self.n_boundary)

    def state_col_indices(self) -> np.ndarray:
        """(N+1, n) flat z-indices of the state at every grid node."""
        rows = np.arange(self.N)[:, None] * self.bw + np.arange(self.n)[None, :]
        tail = self.N * self.bw + np.arange(self.n)
        return np.vstack([rows, tail[None, :]])

    def variable_col_indices(self) -> np.ndarray:
        """(q,) flat z-indices of the static optimization variable v."""
        return self.nz - self.q + np.arange(self.q)

    def control_output_col_indices(self) -> np.ndarray:
        """Flat z-indices of the control entries matching build_solution's
        control output grid row-for-row: (Nc, m) with Nc = len(control_grid)."""
        N, n, m, cs = self.N, self.n, self.m, self.cs
        if m == 0:
            rows = self.Nu * cs + (1 if (cs == 1 and not self.scheme.u_at_nodes) else 0)
            return np.zeros((rows, 0), dtype=int)
        step_cols = (
            np.arange(N)[:, None] * self.bw + n + np.arange(cs * m)[None, :]
        ).reshape(N * cs, m)
        if self.scheme.u_at_nodes:
            tail = self.N * self.bw + n + np.arange(m)
            return np.vstack([step_cols, tail[None, :]])
        if cs == 1:
            return np.vstack([step_cols, step_cols[-1:]])
        return step_cols

    def control_col_indices(self) -> np.ndarray:
        """Flat z-indices of every control entry (all steps, all sub-controls,
        plus the tail node control for u-at-nodes schemes) — e.g. to batch
        per-instance actuator limits through zl/zu."""
        cols = (
            np.arange(self.N)[:, None] * self.bw + self.n + np.arange(self.cs * self.m)[None, :]
        ).ravel()
        if self.scheme.u_at_nodes:
            cols = np.concatenate([cols, self.N * self.bw + self.n + np.arange(self.m)])
        return cols

    # ------------------------------------------------------------------
    # solution building
    # ------------------------------------------------------------------
    def postprocess(self, z):
        """Solution postprocess (X, u_out, v, t) on the device."""
        V = self.unpack(z)
        t = self.time_grid(V.v)
        if self.cs > 1:
            u_out = V.U.reshape(self.Nu * self.cs, self.m)
        else:
            u_out = self.scheme.node_controls(V.U)
        return V.X, u_out, V.v, t

    def build_solution(self, result, message: str = "", infos: Optional[dict] = None,
                       post=None) -> Solution:
        """Map an IPM result to a continuous-time Solution.

        Sign conventions: the IPM minimizes nlp_objective and satisfies
        grad f + J^T lam - zL + zU = 0 (Ipopt's convention). For max problems all
        duals are flipped back to the original problem's sense. The costate
        p(t_i) is the multiplier of defect row i; path duals are divided by the
        local step h_i. `post` optionally carries (X, u_out, v, t) already
        computed by `postprocess`."""
        z = to_numpy(result.z)
        lam = to_numpy(result.lam)
        zL = to_numpy(result.zL)
        zU = to_numpy(result.zU)
        sign = -1.0 if self.ocp.maximize else 1.0
        lam, zL, zU = sign * lam, sign * zL, sign * zU

        if post is None:
            post = self.postprocess(self.tensor(z))
        X, u_out, v, t = (to_numpy(a) for a in post)
        h = t[1:] - t[:-1]
        if self.cs > 1:
            control_grid = np.asarray(self.scheme.control_times(t, h)).ravel()
        else:
            control_grid = t
        P = lam[self.defect_row_indices()]  # (N, n)

        path_duals = None
        if self.n_path > 0:
            pd = lam[self.path_row_indices()]  # (N+1, n_path)
            hn = np.concatenate([h, h[-1:]])  # normalize final row by last step
            path_duals = pd / hn[:, None]
        boundary_duals = (
            lam[self.boundary_row_indices()] if self.n_boundary > 0 else None
        )

        scols = self.state_col_indices()
        ccols = self.control_output_col_indices()
        vcols = self.variable_col_indices()
        box_groups = dict(
            state_box_duals_lower=zL[scols],
            state_box_duals_upper=zU[scols],
            control_box_duals_lower=zL[ccols],
            control_box_duals_upper=zU[ccols],
            variable_box_duals_lower=zL[vcols],
            variable_box_duals_upper=zU[vcols],
        )
        objective = float(result.objective)

        return Solution(
            ocp=self.ocp,
            time_grid=t,
            control_grid=control_grid,
            X=X,
            U=u_out,
            P=P,
            v=v,
            objective=-objective if self.ocp.maximize else objective,
            iterations=int(result.iterations),
            constraints_violation=float(result.constraints_violation),
            status=int(result.status),
            message=message,
            successful=bool(result.successful),
            path_duals=path_duals,
            boundary_duals=boundary_duals,
            lower_box_duals=zL,
            upper_box_duals=zU,
            infos=infos or {},
            **box_groups,
        )


def transcribe(
    ocp: OCP,
    grid_size: int = 250,
    scheme: str = "midpoint",
    time_grid=None,
    control_steps: int = 1,
    *,
    device,
    dtype: torch.dtype = torch.float64,
) -> DOCP:
    """Discretize an OCP into a DOCP whose callbacks run on `device` in `dtype`.

    Defaults mirror the JAX package (grid_size=250, scheme="midpoint")."""
    return DOCP(
        ocp,
        grid_size=grid_size,
        scheme=scheme,
        time_grid=time_grid,
        control_steps=control_steps,
        device=device,
        dtype=dtype,
    )
