"""Discretization schemes as vectorized residual programs (PyTorch port of
`ctdirect_tpu.transcription.schemes`).

Every scheme produces the WHOLE grid of defect residuals and the quadrature in
one vectorized program via `torch.func.vmap` over the grid nodes. Only the
trapeze scheme is ported so far; `get_scheme` raises for the others.

Variable conventions (shapes; N = number of steps):
    X: (N+1, n)     states at grid nodes
    U: (Nu, cs, m)  controls; Nu = N+1 for trapeze (cs=1)
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


SCHEMES = ("trapeze",)

# the JAX package's other schemes, still to be ported
_NOT_PORTED = (
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
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"scheme {name!r} is not ported to ctdirect_tpu_torch yet "
            "(ROADMAP.md, queue 1: other schemes)"
        )
    raise ValueError(f"unknown scheme {name!r}; available: {sorted(SCHEMES + _NOT_PORTED)}")
