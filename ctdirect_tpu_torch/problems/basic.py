"""Basic fixture problems (torch twins of `ctdirect_tpu.problems.basic`: the
same bounds, initial guesses and reference objectives)."""

from __future__ import annotations

import numpy as np
import torch

from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register


def _double_integrator(t, x, u, v):
    return torch.stack([x[1], u[0]])


@register
def double_integrator_minenergy(T: float = 1.0) -> Problem:
    """min-energy double integrator: min ∫u², x(0)=(0,0), x(T)=(1,0).

    Closed form at T=1: u(t) = 6-12t, x=(3t²-2t³, 6t-6t²), costate
    p=(24, 12-24t)."""
    pre = PreOCP("double_integrator_e")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=T)
    pre.dynamics(_double_integrator)
    pre.objective(lagrange=lambda t, x, u, v: u[0] ** 2)
    pre.initial_state([0.0, 0.0]).final_state([1.0, 0.0])
    return Problem(pre.build(), None, "double_integrator_e")


@register
def double_integrator_mintf() -> Problem:
    """min-tf double integrator, |u|<=1: obj tf = 2."""
    pre = PreOCP("double_integrator_tf")
    pre.state(2).control(1).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(_double_integrator)
    pre.objective(mayer=lambda x0, xf, v: v[0])
    pre.control_bounds(lb=[-1.0], ub=[1.0])
    pre.variable_bounds(lb=[0.05], ub=[np.inf])
    pre.initial_state([0.0, 0.0]).final_state([1.0, 0.0])
    return Problem(pre.build(), 2.0, "double_integrator_tf")


@register
def double_integrator_freet0tf() -> Problem:
    """max t0 with both endpoints free: obj 8."""
    pre = PreOCP("double_integ_t0tf")
    pre.state(2).control(1).variable(2)
    pre.time(t0_index=0, tf_index=1)
    pre.dynamics(_double_integrator)
    pre.objective(mayer=lambda x0, xf, v: v[0], maximize=True)
    pre.control_bounds(lb=[-1.0], ub=[1.0])
    pre.variable_bounds(lb=[0.05, 0.05], ub=[10.0, 10.0])
    # 0.01 <= tf - t0 (nonlinear-in-v boundary row)
    pre.boundary_constraint(lambda x0, xf, v: v[1] - v[0], lb=[0.01], ub=[np.inf])
    pre.initial_state([0.0, 0.0]).final_state([1.0, 0.0])
    return Problem(pre.build(), 8.0, "double_integ_t0tf")


@register
def double_integrator_nobounds() -> Problem:
    """min 0.5∫u² from (1,-2) to (0,0) on [0,1]: obj 2."""
    pre = PreOCP("double_integ_nobounds")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(_double_integrator)
    pre.objective(lagrange=lambda t, x, u, v: 0.5 * u[0] ** 2)
    pre.initial_state([1.0, -2.0]).final_state([0.0, 0.0])
    return Problem(pre.build(), 2.0, "double_integ_nobounds")


@register
def beam() -> Problem:
    """Bocop beam: obj 8.898598."""
    pre = PreOCP("beam")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(_double_integrator)
    pre.objective(lagrange=lambda t, x, u, v: u[0] ** 2)
    pre.state_bounds(lb=[0.0, -np.inf], ub=[0.1, np.inf])
    pre.control_bounds(lb=[-10.0], ub=[10.0])
    pre.initial_state([0.0, 1.0]).final_state([0.0, -1.0])
    return Problem(pre.build(), 8.898598, "beam")


@register
def fuller() -> Problem:
    """Fuller: min ∫x1², |u|<=1, obj 0.2683944."""
    pre = PreOCP("fuller")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=3.5)
    pre.dynamics(_double_integrator)
    pre.objective(lagrange=lambda t, x, u, v: x[0] ** 2)
    pre.control_bounds(lb=[-1.0], ub=[1.0])
    pre.initial_state([0.0, 1.0]).final_state([0.0, 0.0])
    return Problem(pre.build(), 2.683944e-1, "fuller")


@register
def vanderpol() -> Problem:
    """Bocop Van der Pol: obj 1.047921."""
    omega, eps = 1.0, 1.0
    pre = PreOCP("vanderpol")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=2.0)
    pre.dynamics(
        lambda t, x, u, v: torch.stack(
            [x[1], eps * omega * (1 - x[0] ** 2) * x[1] - omega**2 * x[0] + u[0]]
        )
    )
    pre.objective(
        lagrange=lambda t, x, u, v: 0.5 * (x[0] ** 2 + x[1] ** 2 + u[0] ** 2)
    )
    pre.initial_state([1.0, 0.0])
    return Problem(pre.build(), 1.047921, "vanderpol")


@register
def jackson() -> Problem:
    """Bocop Jackson chemical reactor: max x3(4), obj 0.192011."""
    k1, k2, k3 = 1.0, 10.0, 1.0
    pre = PreOCP("jackson")
    pre.state(3).control(1)
    pre.time(t0=0.0, tf=4.0)

    def dyn(t, x, u, v):
        a, b = x[0], x[1]
        r = k1 * a - k2 * b
        return torch.stack([-u[0] * r, u[0] * r - (1 - u[0]) * k3 * b, (1 - u[0]) * k3 * b])

    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0, xf, v: xf[2], maximize=True)
    pre.state_bounds(lb=[0.0, 0.0, 0.0], ub=[1.1, 1.1, 1.1])
    pre.control_bounds(lb=[0.0], ub=[1.0])
    pre.initial_state([1.0, 0.0, 0.0])
    return Problem(pre.build(), 0.192011, "jackson")


@register
def robbins() -> Problem:
    """Bocop Robbins: obj 19.4."""
    alpha, beta, gamma = 3.0, 0.0, 0.5
    pre = PreOCP("robbins")
    pre.state(3).control(1)
    pre.time(t0=0.0, tf=10.0)
    pre.dynamics(lambda t, x, u, v: torch.stack([x[1], x[2], u[0]]))
    pre.objective(
        lagrange=lambda t, x, u, v: alpha * x[0] + beta * x[0] ** 2 + gamma * u[0] ** 2
    )
    pre.state_bounds(lb=[0.0, -np.inf, -np.inf], ub=[np.inf, np.inf, np.inf])
    pre.initial_state([1.0, -2.0, 0.0]).final_state([0.0, 0.0, 0.0])
    return Problem(pre.build(), 19.4, "robbins")


@register
def simple_integrator() -> Problem:
    """Dual-control min-energy integrator: obj 0.313."""
    pre = PreOCP("simple_integrator")
    pre.state(1).control(2)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(lambda t, x, u, v: torch.stack([-x[0] - u[0] + u[1]]))
    pre.objective(lagrange=lambda t, x, u, v: (u[0] + u[1]) ** 2)
    pre.control_bounds(lb=[0.0, 0.0], ub=[np.inf, np.inf])
    pre.initial_state([-1.0]).final_state([0.0])
    return Problem(pre.build(), 3.13e-1, "simple_integrator")
