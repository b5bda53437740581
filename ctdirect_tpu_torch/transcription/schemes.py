"""Discretization schemes as vectorized residual programs (PyTorch port of
`ctdirect_tpu.transcription.schemes`).

Every scheme produces the WHOLE grid of defect residuals and the quadrature in
one vectorized program via `torch.func.vmap` over the grid nodes: Trapeze,
Midpoint (with the sub-sampled-control "direct shooting" mode), both Euler
variants and the Gauss-Legendre implicit Runge-Kutta schemes (`GenericIRK`,
with stage variables K and shared or stagewise controls).

Variable conventions (shapes; N = number of steps):
    X: (N+1, n)     states at grid nodes
    U: (Nu, cs, m)  controls; Nu = N+1 for trapeze (cs=1), N otherwise;
                    cs = controls per step (control_steps for direct shooting,
                    s for stagewise IRK, else 1)
    K: (N, s, n)    IRK stage variables (None when s = 0)
    t: (N+1,)       time grid;  h: (N,) steps
    v: (q,)         static optimization variables

Each scheme implements:
    defects(fns, X, U, K, t, h, v) -> (D: (N, n), S: (N, s, n) | None)
    quadrature(fns, X, U, K, t, h, v) -> scalar   (Lagrange running cost)
    node_controls(U) -> (N+1, m)   control value AT each grid node
    control_times(t, h) -> (Nu, cs) times where each stored control lives (numpy)
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap


class OCPFns(NamedTuple):
    """Wrapped, shape-normalized OCP callables (built by DOCP)."""

    dynamics: Callable  # (t, x, u, v) -> (n,)
    lagrange: Optional[Callable]  # (t, x, u, v) -> scalar


def _vdyn(fns, t, x, u, v):
    """vmap dynamics over the leading axis of t/x/u."""
    return vmap(fns.dynamics, in_dims=(0, 0, 0, None))(t, x, u, v)


def _vlag(fns, t, x, u, v):
    return vmap(fns.lagrange, in_dims=(0, 0, 0, None))(t, x, u, v)


class Scheme:
    """Base class. Subclasses are stateless singletons parameterized by dims."""

    name: str = "abstract"
    info: str = ""
    order: int = 0
    stages: int = 0  # number of K stage-variable groups per step
    u_at_nodes: bool = False  # True => U has N+1 rows (trapeze final control)

    def __init__(self, cs: int = 1):
        self.cs = cs

    def u_rows(self, N: int) -> int:
        return N + 1 if self.u_at_nodes else N

    def defects(self, fns, X, U, K, t, h, v):
        raise NotImplementedError

    def quadrature(self, fns, X, U, K, t, h, v):
        raise NotImplementedError

    def node_controls(self, U):
        raise NotImplementedError

    def control_times(self, t, h):
        raise NotImplementedError

    # ---- per-step local forms (single step; used by the structured KKT to
    # assemble block Hessians/Jacobians — must agree exactly with the
    # vectorized defects/quadrature above) ----

    def local_residual(self, fns, ti, tip1, x, U, K, xn, un, v):
        """Defect (+ stage) residuals of ONE step: (n + s*n,)."""
        raise NotImplementedError

    def local_cost(self, fns, ti, tip1, x, U, K, xn, un, v):
        """Lagrange-quadrature contribution of ONE step (scalar)."""
        raise NotImplementedError

    def local_node_control(self, U):
        """Control value at the step's LEFT node (for path rows): (m,)."""
        return U[0]


class Trapeze(Scheme):
    """Trapezoidal (Crank-Nicolson) collocation, 2nd order.

    Layout [X_1,U_1,...,X_{N+1},U_{N+1},V]; defect
    x_{i+1} - x_i - h/2 (f_i + f_{i+1}) and matching trapezoid quadrature.
    """

    name = "trapeze"
    info = "Implicit Trapeze aka Crank-Nicolson, 2nd order, A-stable"
    order = 2
    u_at_nodes = True

    def defects(self, fns, X, U, K, t, h, v):
        F = _vdyn(fns, t, X, U[:, 0, :], v)  # (N+1, n)
        D = X[1:] - X[:-1] - 0.5 * h[:, None] * (F[:-1] + F[1:])
        return D, None

    def quadrature(self, fns, X, U, K, t, h, v):
        L = _vlag(fns, t, X, U[:, 0, :], v)  # (N+1,)
        return torch.sum(0.5 * h * (L[:-1] + L[1:]))

    def node_controls(self, U):
        return U[:, 0, :]

    def control_times(self, t, h):
        return np.asarray(t)[:, None]

    def local_residual(self, fns, ti, tip1, x, U, K, xn, un, v):
        h = tip1 - ti
        F0 = fns.dynamics(ti, x, U[0], v)
        F1 = fns.dynamics(tip1, xn, un, v)
        return xn - x - 0.5 * h * (F0 + F1)

    def local_cost(self, fns, ti, tip1, x, U, K, xn, un, v):
        h = tip1 - ti
        return 0.5 * h * (fns.lagrange(ti, x, U[0], v) + fns.lagrange(tip1, xn, un, v))


class Midpoint(Scheme):
    """Implicit midpoint (= Gauss-Legendre s=1 without stage vars), 2nd order.

    Defect x_{i+1} - x_i - (h/cs) * sum_j f(t_mid, x_mid, u_ij); with cs = 1 this is
    the classic midpoint rule. cs > 1 is the sub-sampled-control ("direct
    shooting") mode.
    """

    name = "midpoint"
    info = "Implicit Midpoint aka Gauss-Legendre collocation for s=1, 2nd order, symplectic"
    order = 2

    def defects(self, fns, X, U, K, t, h, v):
        tmid = 0.5 * (t[:-1] + t[1:])  # (N,)
        xmid = 0.5 * (X[:-1] + X[1:])  # (N, n)
        cs = U.shape[1]

        def step_dyn(ts, xs, u_cs):
            return vmap(fns.dynamics, in_dims=(None, None, 0, None))(ts, xs, u_cs, v)

        F = vmap(step_dyn)(tmid, xmid, U)  # (N, cs, n)
        D = X[1:] - X[:-1] - (h / cs)[:, None] * torch.sum(F, dim=1)
        return D, None

    def quadrature(self, fns, X, U, K, t, h, v):
        xmid = 0.5 * (X[:-1] + X[1:])
        cs = U.shape[1]
        if cs == 1:
            tmid = 0.5 * (t[:-1] + t[1:])
            L = _vlag(fns, tmid, xmid, U[:, 0, :], v)
            return torch.sum(h * L)
        hsub = h / cs  # (N,)
        j = torch.arange(cs, dtype=t.dtype, device=t.device)
        tij = t[:-1, None] + (j[None, :] + 0.5) * hsub[:, None]  # (N, cs)

        def step_lag(t_cs, xs, u_cs):
            return vmap(fns.lagrange, in_dims=(0, None, 0, None))(t_cs, xs, u_cs, v)

        L = vmap(step_lag)(tij, xmid, U)  # (N, cs)
        return torch.sum(hsub[:, None] * L)

    def node_controls(self, U):
        u = U[:, 0, :]
        return torch.cat([u, u[-1:]], dim=0)

    def control_times(self, t, h):
        t, h = np.asarray(t), np.asarray(h)
        cs = self.cs
        if cs == 1:
            return t[:-1, None]
        j = np.arange(cs)
        return t[:-1, None] + (j[None, :] + 0.5) * (h / cs)[:, None]

    def local_residual(self, fns, ti, tip1, x, U, K, xn, un, v):
        h = tip1 - ti
        tm = 0.5 * (ti + tip1)
        xm = 0.5 * (x + xn)
        cs = U.shape[0]
        F = vmap(fns.dynamics, in_dims=(None, None, 0, None))(tm, xm, U, v)
        return xn - x - (h / cs) * torch.sum(F, dim=0)

    def local_cost(self, fns, ti, tip1, x, U, K, xn, un, v):
        h = tip1 - ti
        xm = 0.5 * (x + xn)
        cs = U.shape[0]
        if cs == 1:
            tm = 0.5 * (ti + tip1)
            return h * fns.lagrange(tm, xm, U[0], v)
        hsub = h / cs
        tij = ti + (torch.arange(cs, dtype=x.dtype, device=x.device) + 0.5) * hsub
        L = vmap(fns.lagrange, in_dims=(0, None, 0, None))(tij, xm, U, v)
        return hsub * torch.sum(L)


class Euler(Scheme):
    """Explicit / implicit Euler, 1st order.

    Control convention: explicit u applies on [t_i, t_{i+1}) and the step
    reads U_i at t_i; implicit u applies on (t_i, t_{i+1}] and the step reads
    U_i at t_{i+1}.
    """

    order = 1

    def __init__(self, explicit: bool, cs: int = 1):
        super().__init__(cs)
        self.explicit = explicit
        self.name = "euler" if explicit else "euler_implicit"
        self.info = f"{'Explicit' if explicit else 'Implicit'} Euler, 1st order"

    def defects(self, fns, X, U, K, t, h, v):
        if self.explicit:
            F = _vdyn(fns, t[:-1], X[:-1], U[:, 0, :], v)
        else:
            F = _vdyn(fns, t[1:], X[1:], U[:, 0, :], v)
        D = X[1:] - X[:-1] - h[:, None] * F
        return D, None

    def quadrature(self, fns, X, U, K, t, h, v):
        if self.explicit:
            L = _vlag(fns, t[:-1], X[:-1], U[:, 0, :], v)
        else:
            L = _vlag(fns, t[1:], X[1:], U[:, 0, :], v)
        return torch.sum(h * L)

    def node_controls(self, U):
        # forward association (node i -> U_i, clamped at N) for BOTH variants,
        # as in the JAX package: every constraint block stays local to
        # (w_i, w_{i+1}), which the block-tridiagonal KKT relies on
        u = U[:, 0, :]
        return torch.cat([u, u[-1:]], dim=0)

    def control_times(self, t, h):
        t = np.asarray(t)
        return (t[:-1] if self.explicit else t[1:])[:, None]

    def local_residual(self, fns, ti, tip1, x, U, K, xn, un, v):
        h = tip1 - ti
        if self.explicit:
            return xn - x - h * fns.dynamics(ti, x, U[0], v)
        return xn - x - h * fns.dynamics(tip1, xn, U[0], v)

    def local_cost(self, fns, ti, tip1, x, U, K, xn, un, v):
        h = tip1 - ti
        if self.explicit:
            return h * fns.lagrange(ti, x, U[0], v)
        return h * fns.lagrange(tip1, xn, U[0], v)


class GenericIRK(Scheme):
    """Implicit Runge-Kutta collocation with stage variables K.

    Stage equations  K_i^j = f(t_i + c_j h, x_i + h * sum_l a_jl K_i^l, u_i^j, v)
    and defect       x_{i+1} = x_i + h * sum_j b_j K_i^j.
    `stagewise=True` gives a distinct control per stage U_i^j; otherwise the
    step control U_i is shared by all stages. The Butcher arrays are kept in
    numpy and become tensors on the input's device and dtype at every call.
    """

    def __init__(self, name, info, order, A, b, c, stagewise: bool):
        self.A = np.asarray(A, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        self.c = np.asarray(c, dtype=np.float64)
        self.stages = len(self.b)
        self.stagewise = stagewise
        super().__init__(cs=self.stages if stagewise else 1)
        self.name = name
        self.info = info
        self.order = order

    def _tableau(self, like):
        """(A, b, c) as tensors on `like`'s device, in its dtype."""
        return tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                     for a in (self.A, self.b, self.c))

    def _stage_controls(self, U):
        """(N, s, m) control used at each stage."""
        if self.stagewise:
            return U
        return U.expand(U.shape[0], self.stages, U.shape[2])

    def _stage_txu(self, X, U, K, t, h):
        """Stage times, states and controls (N, s, ...) and the weights b."""
        A, b, c = self._tableau(X)
        tij = t[:-1, None] + c[None, :] * h[:, None]  # (N, s)
        Xij = X[:-1, None, :] + h[:, None, None] * torch.einsum("jl,nlx->njx", A, K)
        return tij, Xij, self._stage_controls(U), b

    def _flat_stages(self, fn, tij, Xij, Uij, v):
        """fn over every (step, stage) pair -> (N, s, ...)."""
        N, s = tij.shape
        out = vmap(fn, in_dims=(0, 0, 0, None))(
            tij.reshape(N * s), Xij.reshape(N * s, Xij.shape[-1]),
            Uij.reshape(N * s, Uij.shape[-1]), v,
        )
        return out.reshape((N, s) + out.shape[1:])

    def defects(self, fns, X, U, K, t, h, v):
        tij, Xij, Uij, b = self._stage_txu(X, U, K, t, h)
        F = self._flat_stages(fns.dynamics, tij, Xij, Uij, v)  # (N, s, n)
        S = K - F  # stage residuals (N, s, n)
        D = X[1:] - X[:-1] - h[:, None] * torch.einsum("j,njx->nx", b, K)
        return D, S

    def quadrature(self, fns, X, U, K, t, h, v):
        tij, Xij, Uij, b = self._stage_txu(X, U, K, t, h)
        L = self._flat_stages(fns.lagrange, tij, Xij, Uij, v)  # (N, s)
        return torch.sum(h[:, None] * b[None, :] * L)

    def node_controls(self, U):
        if self.stagewise:
            # compatibility averaged control sum_j b_j U_i^j
            _, b, _ = self._tableau(U)
            u = torch.einsum("j,njm->nm", b, U)
        else:
            u = U[:, 0, :]
        return torch.cat([u, u[-1:]], dim=0)

    def local_node_control(self, U):
        if self.stagewise:
            _, b, _ = self._tableau(U)
            return torch.einsum("j,jm->m", b, U)
        return U[0]

    def _local_stages(self, ti, tip1, x, U, K):
        h = tip1 - ti
        A, b, c = self._tableau(x)
        tij = ti + c * h  # (s,)
        Xij = x[None, :] + h * torch.einsum("jl,lx->jx", A, K)  # (s, n)
        Uij = U if self.stagewise else U.expand(self.stages, U.shape[1])
        return h, b, tij, Xij, Uij

    def local_residual(self, fns, ti, tip1, x, U, K, xn, un, v):
        h, b, tij, Xij, Uij = self._local_stages(ti, tip1, x, U, K)
        F = vmap(fns.dynamics, in_dims=(0, 0, 0, None))(tij, Xij, Uij, v)
        S = K - F  # (s, n)
        D = xn - x - h * torch.einsum("j,jx->x", b, K)
        return torch.cat([D, S.reshape(-1)])

    def local_cost(self, fns, ti, tip1, x, U, K, xn, un, v):
        h, b, tij, Xij, Uij = self._local_stages(ti, tip1, x, U, K)
        L = vmap(fns.lagrange, in_dims=(0, 0, 0, None))(tij, Xij, Uij, v)
        return h * torch.dot(b, L)

    def control_times(self, t, h):
        t, h = np.asarray(t), np.asarray(h)
        if self.stagewise:
            # init sampled at the stage times t_i + c_j h
            return t[:-1, None] + self.c[None, :] * h[:, None]
        return t[:-1, None]


_SQ3, _SQ15 = math.sqrt(3.0), math.sqrt(15.0)

_GL1 = dict(A=[[0.5]], b=[1.0], c=[0.5])
_GL2 = dict(
    A=[[0.25, 0.25 - _SQ3 / 6], [0.25 + _SQ3 / 6, 0.25]],
    b=[0.5, 0.5],
    c=[0.5 - _SQ3 / 6, 0.5 + _SQ3 / 6],
)
_GL3 = dict(
    A=[
        [5 / 36, 2 / 9 - _SQ15 / 15, 5 / 36 - _SQ15 / 30],
        [5 / 36 + _SQ15 / 24, 2 / 9, 5 / 36 - _SQ15 / 24],
        [5 / 36 + _SQ15 / 30, 2 / 9 + _SQ15 / 15, 5 / 36],
    ],
    b=[5 / 18, 4 / 9, 5 / 18],
    c=[0.5 - _SQ15 / 10, 0.5, 0.5 + _SQ15 / 10],
)

# name -> (info, order, stagewise, tableau). As in the JAX package, the plain
# gauss_legendre_{2,3} names are the STAGEWISE variants (a control per stage);
# the shared-control forms carry the _constant_control suffix.
_IRK = {
    "gauss_legendre_1": (
        "[test only] Implicit Midpoint as IRK s=1, 2nd order, symplectic, A-stable", 2, False, _GL1),
    "gauss_legendre_2": (
        "Implicit Gauss-Legendre collocation s=2, 4th order, stagewise controls", 4, True, _GL2),
    "gauss_legendre_3": (
        "Implicit Gauss-Legendre collocation s=3, 6th order, stagewise controls", 6, True, _GL3),
    "gauss_legendre_2_constant_control": (
        "Implicit Gauss-Legendre collocation s=2, 4th order, constant control", 4, False, _GL2),
    "gauss_legendre_3_constant_control": (
        "Implicit Gauss-Legendre collocation s=3, 6th order, constant control", 6, False, _GL3),
}


SCHEMES = (
    "trapeze",
    "midpoint",
    "euler",
    "euler_explicit",
    "euler_forward",
    "euler_implicit",
    "euler_backward",
    "gauss_legendre_1",
    "gauss_legendre_2",
    "gauss_legendre_3",
    "gauss_legendre_2_constant_control",
    "gauss_legendre_3_constant_control",
)


def get_scheme(name: str, control_steps: int = 1) -> Scheme:
    if control_steps != 1 and name != "midpoint":
        raise ValueError("control_steps > 1 (direct shooting) requires scheme='midpoint'")
    if name == "trapeze":
        return Trapeze()
    if name == "midpoint":
        return Midpoint(cs=control_steps)
    if name in ("euler", "euler_explicit", "euler_forward"):
        return Euler(explicit=True)
    if name in ("euler_implicit", "euler_backward"):
        return Euler(explicit=False)
    if name in _IRK:
        info, order, stagewise, tableau = _IRK[name]
        return GenericIRK(name, info, order, stagewise=stagewise, **tableau)
    raise ValueError(f"unknown scheme {name!r}; available: {sorted(SCHEMES)}")
