"""OCP model layer: problem specification + fluent construction API.

Plays the role of CTModels.jl in the reference stack (SURVEY.md L1): the `PreOCP`
class mirrors `CTModels.PreModel` (`state!/control!/variable!/time!/dynamics!/
constraint!/objective!/build` — reference test/problems/goddard.jl:99–150), and the
built `OCP` is the immutable spec consumed by transcription.

Math contract (reference docs/src/index.md:15–43): minimize
    g(x(t0), x(tf), v) + ∫ f0(t, x(t), u(t), v) dt        (Mayer + Lagrange = Bolza)
subject to dx/dt = f(t, x, u, v), lb <= g_path(t, x, u, v) <= ub,
lb <= b(x(t0), x(tf), v) <= ub, and box bounds on x, u, v. `v` is a static
optimization-variable vector (e.g. free initial/final time).

All user callables take/return torch tensors and must be traceable by
`torch.func` transforms (vmap, jacfwd, hessian): build vectors with
`torch.stack`, never with `torch.tensor([...])`, which breaks under them:
    dynamics(t, x, u, v) -> (n,)
    lagrange(t, x, u, v) -> scalar
    mayer(x0, xf, v) -> scalar
    path(t, x, u, v) -> (n_path,)
    boundary(x0, xf, v) -> (n_boundary,)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

Array = np.ndarray
INF = np.inf


@dataclass(frozen=True)
class TimeSpec:
    """Initial/final time, each either a fixed float or an index into v.

    Mirrors the reference's free-time handling (DOCP_data.jl:176–214): when either
    endpoint is free the grid is stored normalized in [0,1] and the real grid
    t = t0(v) + s*(tf(v) - t0(v)) is recomputed from v on every NLP evaluation.
    """

    t0: Optional[float] = None
    tf: Optional[float] = None
    t0_index: Optional[int] = None  # index into v when t0 is free
    tf_index: Optional[int] = None  # index into v when tf is free

    def __post_init__(self):
        if (self.t0 is None) == (self.t0_index is None):
            raise ValueError("exactly one of t0 / t0_index must be given")
        if (self.tf is None) == (self.tf_index is None):
            raise ValueError("exactly one of tf / tf_index must be given")

    @property
    def free_t0(self) -> bool:
        return self.t0_index is not None

    @property
    def free_tf(self) -> bool:
        return self.tf_index is not None

    @property
    def fixed(self) -> bool:
        return not (self.free_t0 or self.free_tf)


@dataclass(frozen=True)
class OCP:
    """Immutable optimal control problem spec (static config; not a pytree)."""

    n: int  # state dimension
    m: int  # control dimension (0 allowed: pure parameter estimation)
    q: int  # optimization-variable dimension (0 allowed)
    time: TimeSpec
    dynamics: Callable  # (t, x, u, v) -> (n,)
    lagrange: Optional[Callable] = None  # (t, x, u, v) -> scalar
    mayer: Optional[Callable] = None  # (x0, xf, v) -> scalar
    maximize: bool = False
    path: Optional[Callable] = None  # (t, x, u, v) -> (n_path,)
    path_lb: Optional[Array] = None
    path_ub: Optional[Array] = None
    boundary: Optional[Callable] = None  # (x0, xf, v) -> (n_boundary,)
    boundary_lb: Optional[Array] = None
    boundary_ub: Optional[Array] = None
    x_lb: Array = None  # (n,)
    x_ub: Array = None
    u_lb: Array = None  # (m,)
    u_ub: Array = None
    v_lb: Array = None  # (q,)
    v_ub: Array = None
    name: str = "ocp"

    # ---- derived dims / flags (≙ DOCPFlags, DOCP_data.jl:24–66) ----
    @property
    def n_path(self) -> int:
        return 0 if self.path_lb is None else int(self.path_lb.shape[0])

    @property
    def n_boundary(self) -> int:
        return 0 if self.boundary_lb is None else int(self.boundary_lb.shape[0])

    @property
    def has_lagrange(self) -> bool:
        return self.lagrange is not None

    @property
    def has_mayer(self) -> bool:
        return self.mayer is not None

    def __repr__(self):  # keep callables out of the repr
        return (
            f"OCP(name={self.name!r}, n={self.n}, m={self.m}, q={self.q}, "
            f"n_path={self.n_path}, n_boundary={self.n_boundary}, "
            f"mayer={self.has_mayer}, lagrange={self.has_lagrange}, "
            f"maximize={self.maximize}, free_t0={self.time.free_t0}, "
            f"free_tf={self.time.free_tf})"
        )


def _as_bounds(val, dim: int, default: float) -> Array:
    if val is None:
        return np.full((dim,), default, dtype=np.float64)
    arr = np.atleast_1d(np.asarray(val, dtype=np.float64))
    if arr.shape != (dim,):
        raise ValueError(f"bounds shape {arr.shape} != ({dim},)")
    return arr


def _state_index(k: int, rg):
    """Index into a state vector: a slice where the components are
    consecutive (the leading k by default), else a tuple of ints for
    `_take`. Neither makes an index tensor from host data on every call,
    which a CUDA graph could not capture."""
    if rg is None:
        return slice(0, k)
    rg = [int(i) for i in np.asarray(rg, dtype=int)]
    if rg == list(range(rg[0], rg[0] + len(rg))):
        return slice(rg[0], rg[0] + len(rg))
    return tuple(rg)


def _take(x, idx):
    """x[idx] for a `_state_index`: a view, or the entries stacked."""
    if isinstance(idx, slice):
        return x[idx]
    return torch.stack([x[i] for i in idx])


class PreOCP:
    """Mutable OCP under construction, mirroring CTModels.PreModel.

    Example (Goddard, reference test/problems/goddard.jl:87–158)::

        pre = PreOCP("goddard")
        pre.state(3)
        pre.control(1)
        pre.variable(1)
        pre.time(t0=0.0, tf_index=0)
        pre.dynamics(f)                       # f(t, x, u, v) -> (3,)
        pre.objective(mayer=lambda x0, xf, v: xf[0], maximize=True)
        pre.state_bounds(lb=[1, 0, 0.6], ub=[1.1, 0.1, 1])
        pre.control_bounds(lb=[0], ub=[1])
        pre.variable_bounds(lb=[0.01], ub=[np.inf])
        pre.boundary_constraint(lambda x0, xf, v: torch.stack([*x0, xf[2]]),
                                lb=[1, 0, 1, 0.6], ub=[1, 0, 1, 0.6])
        ocp = pre.build()
    """

    def __init__(self, name: str = "ocp"):
        self._name = name
        self._n = self._m = self._q = None
        self._time: Optional[TimeSpec] = None
        self._dynamics = None
        self._lagrange = None
        self._mayer = None
        self._maximize = False
        self._path_entries: list = []  # (f, lb, ub)
        self._boundary_entries: list = []  # (f, lb, ub)
        self._x_lb = self._x_ub = None
        self._u_lb = self._u_ub = None
        self._v_lb = self._v_ub = None

    # ---- dimensions ----
    def state(self, n: int):
        self._n = int(n)
        return self

    def control(self, m: int):
        self._m = int(m)
        return self

    def variable(self, q: int):
        self._q = int(q)
        return self

    # ---- time ----
    def time(self, t0=None, tf=None, t0_index=None, tf_index=None):
        self._time = TimeSpec(t0=t0, tf=tf, t0_index=t0_index, tf_index=tf_index)
        return self

    # ---- functions ----
    def dynamics(self, f: Callable):
        self._dynamics = f
        return self

    def objective(self, mayer=None, lagrange=None, maximize: bool = False):
        if mayer is None and lagrange is None:
            raise ValueError("objective needs mayer and/or lagrange")
        self._mayer, self._lagrange, self._maximize = mayer, lagrange, maximize
        return self

    def path_constraint(self, f: Callable, lb, ub):
        lb = np.atleast_1d(np.asarray(lb, dtype=np.float64))
        ub = np.atleast_1d(np.asarray(ub, dtype=np.float64))
        if lb.shape != ub.shape:
            raise ValueError("path constraint lb/ub shape mismatch")
        self._path_entries.append((f, lb, ub))
        return self

    def boundary_constraint(self, f: Callable, lb, ub):
        lb = np.atleast_1d(np.asarray(lb, dtype=np.float64))
        ub = np.atleast_1d(np.asarray(ub, dtype=np.float64))
        if lb.shape != ub.shape:
            raise ValueError("boundary constraint lb/ub shape mismatch")
        self._boundary_entries.append((f, lb, ub))
        return self

    # convenience: pin initial / final state (== boundary equality rows)
    def initial_state(self, x0, rg: Optional[Sequence[int]] = None):
        x0 = np.atleast_1d(np.asarray(x0, dtype=np.float64))
        idx = _state_index(len(x0), rg)

        def f(xa, xb, v, idx=idx):
            return _take(xa, idx)

        return self.boundary_constraint(f, x0, x0)

    def final_state(self, xf, rg: Optional[Sequence[int]] = None):
        xf = np.atleast_1d(np.asarray(xf, dtype=np.float64))
        idx = _state_index(len(xf), rg)

        def f(xa, xb, v, idx=idx):
            return _take(xb, idx)

        return self.boundary_constraint(f, xf, xf)

    # ---- box bounds (indexed ranges expand to ±inf vectors, ≙ build_bounds_block,
    # DOCP_variables.jl:88–98; repeated calls intersect) ----
    def _set_box(self, cur_lb, cur_ub, dim, lb, ub, rg):
        full_lb = np.full((dim,), -INF) if cur_lb is None else cur_lb
        full_ub = np.full((dim,), INF) if cur_ub is None else cur_ub
        idx = np.arange(dim) if rg is None else np.asarray(rg, dtype=int)
        if lb is not None:
            lb = np.atleast_1d(np.asarray(lb, dtype=np.float64))
            full_lb[idx] = np.maximum(full_lb[idx], lb)
        if ub is not None:
            ub = np.atleast_1d(np.asarray(ub, dtype=np.float64))
            full_ub[idx] = np.minimum(full_ub[idx], ub)
        return full_lb, full_ub

    def state_bounds(self, lb=None, ub=None, rg=None):
        if self._n is None:
            raise ValueError("call state(n) before state_bounds")
        self._x_lb, self._x_ub = self._set_box(self._x_lb, self._x_ub, self._n, lb, ub, rg)
        return self

    def control_bounds(self, lb=None, ub=None, rg=None):
        if self._m is None:
            raise ValueError("call control(m) before control_bounds")
        self._u_lb, self._u_ub = self._set_box(self._u_lb, self._u_ub, self._m, lb, ub, rg)
        return self

    def variable_bounds(self, lb=None, ub=None, rg=None):
        if self._q is None:
            raise ValueError("call variable(q) before variable_bounds")
        self._v_lb, self._v_ub = self._set_box(self._v_lb, self._v_ub, self._q, lb, ub, rg)
        return self

    # ---- build ----
    def build(self) -> OCP:
        if self._n is None:
            raise ValueError("state dimension not set")
        m = 0 if self._m is None else self._m
        q = 0 if self._q is None else self._q
        if self._time is None:
            raise ValueError("time not set")
        if self._dynamics is None:
            raise ValueError("dynamics not set")
        if self._mayer is None and self._lagrange is None:
            raise ValueError("objective not set")
        for label, idx in (("t0", self._time.t0_index), ("tf", self._time.tf_index)):
            if idx is not None and not (0 <= idx < q):
                raise ValueError(f"{label}_index {idx} out of range for variable dim {q}")

        # concatenate multi-entry path/boundary constraints into single callables
        def concat_entries(entries, nargs):
            if not entries:
                return None, None, None
            if len(entries) == 1:
                f, lb, ub = entries[0]
                return f, lb, ub
            fns = [e[0] for e in entries]
            lb = np.concatenate([e[1] for e in entries])
            ub = np.concatenate([e[2] for e in entries])

            def combined(*args):
                return torch.cat([torch.atleast_1d(fn(*args)) for fn in fns])

            return combined, lb, ub

        path, path_lb, path_ub = concat_entries(self._path_entries, 4)
        boundary, boundary_lb, boundary_ub = concat_entries(self._boundary_entries, 3)

        return OCP(
            n=self._n,
            m=m,
            q=q,
            time=self._time,
            dynamics=self._dynamics,
            lagrange=self._lagrange,
            mayer=self._mayer,
            maximize=self._maximize,
            path=path,
            path_lb=path_lb,
            path_ub=path_ub,
            boundary=boundary,
            boundary_lb=boundary_lb,
            boundary_ub=boundary_ub,
            x_lb=_as_bounds(self._x_lb, self._n, -INF),
            x_ub=_as_bounds(self._x_ub, self._n, INF),
            u_lb=_as_bounds(self._u_lb, m, -INF),
            u_ub=_as_bounds(self._u_ub, m, INF),
            v_lb=_as_bounds(self._v_lb, q, -INF),
            v_ub=_as_bounds(self._v_ub, q, INF),
            name=self._name,
        )


def replace(ocp: OCP, **kwargs) -> OCP:
    """Functional update of an OCP spec."""
    return dataclasses.replace(ocp, **kwargs)
