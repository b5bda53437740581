"""Zero-control parameter-estimation fixtures, the all-couplings `pattern`
problem and the minimum-action problem (torch twins of
`ctdirect_tpu.problems.misc`)."""

from __future__ import annotations

import math

import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register


@register
def estimate_initial_condition() -> Problem:
    """Zero-control: estimate x(0) of a harmonic oscillator from an x(T)
    target. Solution v = [1, 0]. Exercises m = 0 end to end."""
    pre = PreOCP("estimate_initial")
    pre.state(2).control(0).variable(2)
    pre.time(t0=0.0, tf=math.pi / 2)
    pre.dynamics(lambda t, x, u, v: torch.stack([-x[1], x[0]]))
    pre.objective(mayer=lambda x0, xf, v: xf[0] ** 2 + (xf[1] - 1.0) ** 2)
    pre.boundary_constraint(lambda x0, xf, v: x0 - v, lb=[0.0, 0.0], ub=[0.0, 0.0])
    return Problem(pre.build(), None, "estimate_initial")


@register
def estimate_rotation_rate() -> Problem:
    """Zero-control: estimate the rotation rate alpha (~ pi/2) with a small
    regularization."""
    pre = PreOCP("estimate_rotation")
    pre.state(2).control(0).variable(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(lambda t, x, u, v: v[0] * torch.stack([-x[1], x[0]]))
    pre.objective(
        mayer=lambda x0, xf, v: xf[0] ** 2 + (xf[1] - 1.0) ** 2 + 0.01 * v[0] ** 2
    )
    pre.initial_state([1.0, 0.0])
    return Problem(pre.build(), None, "estimate_rotation")


@register
def pattern() -> Problem:
    """Dummy problem exercising every KKT coupling at dims (1,1,1): nonlinear
    dynamics in (x, u, v), Lagrange cost in all three, and a boundary row
    x(0) + x(1) + v = 0."""
    pre = PreOCP("pattern")
    pre.state(1).control(1).variable(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(lambda t, x, u, v: torch.stack([x[0] ** 2 + u[0] ** 2 + v[0] ** 2]))
    pre.objective(lagrange=lambda t, x, u, v: u[0] ** 2 + x[0] ** 2 + v[0] ** 2)
    pre.boundary_constraint(
        lambda x0, xf, v: torch.stack([x0[0] + xf[0] + v[0]]), lb=[0.0], ub=[0.0]
    )
    return Problem(pre.build(), None, "pattern")


@register
def action() -> Problem:
    """Minimum-action path between the wells of a double-well vector field;
    no stored objective."""
    T = 50.0
    eps = 1e-1

    def field(x):
        u_, v_ = x[0], x[1]
        return torch.stack([u_ - u_**3 - 10 * u_ * v_**2, -(1 - u_**2) * v_])

    def lag(t, x, u, v):
        fx = field(x)
        unorm2 = u[0] ** 2 + u[1] ** 2
        fnorm2 = fx[0] ** 2 + fx[1] ** 2
        dotuf = u[0] * fx[0] + u[1] * fx[1]
        return torch.sqrt(torch.sqrt((unorm2 * fnorm2) ** 2 + eps**2)) - dotuf

    pre = PreOCP("action")
    pre.state(2).control(2)
    pre.time(t0=0.0, tf=T)
    pre.dynamics(lambda t, x, u, v: u)
    pre.objective(lagrange=lag)
    pre.initial_state([-1.0, 0.0]).final_state([1.0, 0.0])

    def x1(t):
        return -(1 - t / T) + t / T

    def xinit(t):
        return [x1(t), 0.3 * (-x1(t) ** 2 + 1)]

    def uinit(t):  # host-side init, evaluated in float64 on the CPU
        return field(torch.tensor(xinit(t), dtype=torch.float64)).numpy()

    return Problem(pre.build(), None, "action", init=InitialGuess(state=xinit, control=uinit))
