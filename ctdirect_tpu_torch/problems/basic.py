"""Basic fixture problems (torch twins of `ctdirect_tpu.problems.basic`)."""

from __future__ import annotations

import torch

from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register


@register
def double_integrator_minenergy(T: float = 1.0) -> Problem:
    """min-energy double integrator: min ∫u², x(0)=(0,0), x(T)=(1,0).

    Closed form at T=1: u(t) = 6-12t, x=(3t²-2t³, 6t-6t²), costate
    p=(24, 12-24t)."""
    pre = PreOCP("double_integrator_e")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=T)
    pre.dynamics(lambda t, x, u, v: torch.stack([x[1], u[0]]))
    pre.objective(lagrange=lambda t, x, u, v: u[0] ** 2)
    pre.initial_state([0.0, 0.0]).final_state([1.0, 0.0])
    return Problem(pre.build(), None, "double_integrator_e")
