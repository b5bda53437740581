"""Goddard rocket ascent (torch twins of `ctdirect_tpu.problems.goddard`):
free final time, max final altitude, fixed final mass, speed path bound via
the state box."""

from __future__ import annotations

import numpy as np
import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register


def _goddard_dynamics(Cd, beta, b, Tmax):
    def dyn(t, x, u, v):
        r, vel, m = x[0], x[1], x[2]
        D = Cd * vel**2 * torch.exp(-beta * (r - 1.0))
        return torch.stack([vel, -D / m - 1.0 / r**2 + u[0] * Tmax / m, -b * Tmax * u[0]])

    return dyn


def _goddard_init():
    return InitialGuess(state=[1.01, 0.05, 0.8], variable=[0.1])


@register
def goddard(vmax: float = 0.1, Tmax: float = 3.5) -> Problem:
    """obj 1.01257. State box r∈[1,1.1], v∈[0,vmax], m∈[mf,m0]."""
    Cd, beta, b = 310.0, 500.0, 2.0
    r0, v0, m0, mf = 1.0, 0.0, 1.0, 0.6
    pre = PreOCP("goddard")
    pre.state(3).control(1).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(_goddard_dynamics(Cd, beta, b, Tmax))
    pre.objective(mayer=lambda x0, xf, v: xf[0], maximize=True)
    pre.state_bounds(lb=[r0, v0, mf], ub=[r0 + 0.1, vmax, m0])
    pre.control_bounds(lb=[0.0], ub=[1.0])
    pre.variable_bounds(lb=[0.01], ub=[np.inf])
    pre.initial_state([r0, v0, m0])
    pre.final_state([mf], rg=[2])  # m(tf) == mf
    return Problem(pre.build(), 1.01257, "goddard", init=_goddard_init())


@register
def goddard_all() -> Problem:
    """Goddard with every constraint type exercised at once: state/control/
    variable partial boxes + 3-row nonlinear path constraint + boundary rows.
    obj 1.01257."""
    Cd, beta, b = 310.0, 500.0, 2.0
    r0, v0, m0, mf = 1.0, 0.0, 1.0, 0.6
    vmax, Tmax = 0.1, 3.5
    pre = PreOCP("goddard_all_constraints")
    pre.state(3).control(1).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(_goddard_dynamics(Cd, beta, b, Tmax))
    pre.objective(mayer=lambda x0, xf, v: xf[0], maximize=True)
    pre.state_bounds(lb=[r0, v0, 0.0], ub=[np.inf, np.inf, m0])
    pre.control_bounds(lb=[0.0], ub=[np.inf])
    pre.variable_bounds(lb=[0.01], ub=[np.inf])
    pre.path_constraint(
        lambda t, x, u, v: torch.stack([x[1], u[0], x[0] + x[1] + x[2] + u[0] + v[0]]),
        lb=[-np.inf, -np.inf, 0.0],
        ub=[vmax, 1.0, np.inf],
    )
    pre.boundary_constraint(
        lambda x0, xf, v: torch.stack([x0[0], x0[1], x0[2], xf[2]]),
        lb=[r0, v0, m0, mf],
        ub=[r0, v0, m0, mf],
    )
    return Problem(pre.build(), 1.01257, "goddard_all_constraints", init=_goddard_init())
