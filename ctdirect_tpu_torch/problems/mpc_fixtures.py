"""Cart-pole swing-up and planar orbit transfer (torch twins of
`ctdirect_tpu.problems.mpc_fixtures`; BASELINE.json configs 3 and 4). The
reference objectives are the JAX package's (see its module docstring for how
they were certified), and `swimmer2`, an alias of `vehicles.swimmer`."""

from __future__ import annotations

import numpy as np
import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register


def cartpole_dynamics(mc: float = 1.0, mp: float = 0.3, l: float = 0.5, g: float = 9.81):
    """Cart-pole ODE right-hand side; theta = 0 is the DOWN (stable) position,
    theta = pi upright. States [x, dx, th, dth], control [force]."""

    def dyn(t, x, u, v):
        dx, th, dth = x[1], x[2], x[3]
        sth, cth = torch.sin(th), torch.cos(th)
        denom = mc + mp * sth**2
        ddx = (u[0] + mp * sth * (l * dth**2 + g * cth)) / denom
        ddth = (-u[0] * cth - mp * l * dth**2 * cth * sth - (mc + mp) * g * sth) / (
            l * denom
        )
        return torch.stack([dx, ddx, dth, ddth])

    return dyn


@register
def cartpole() -> Problem:
    """Cart-pole swing-up: hanging (th=0) to upright (th=pi) in T=2s, min energy.

    The cart position box |x| <= 0.7 and the force box |u| <= 12 both
    saturate during the swing, so warm-started MPC on this problem tracks a
    switching active set."""
    pre = PreOCP("cartpole")
    pre.state(4).control(1)
    pre.time(t0=0.0, tf=2.0)
    pre.dynamics(cartpole_dynamics())
    pre.objective(lagrange=lambda t, x, u, v: u[0] ** 2)
    pre.state_bounds(lb=[-0.7], ub=[0.7], rg=[0])
    pre.control_bounds(lb=[-12.0], ub=[12.0])
    pre.initial_state([0.0, 0.0, 0.0, 0.0])
    pre.final_state([0.0, 0.0, np.pi, 0.0])
    init = InitialGuess(
        state=lambda t: [0.0, 0.0, np.pi * (t / 2.0) ** 2, np.pi * t],
        control=[0.0],
    )
    return Problem(pre.build(), 70.365571, "cartpole", init=init)


@register
def orbit_transfer() -> Problem:
    """Planar low-thrust orbit transfer, fuel-min (smoothed L1), free tf.

    Normalized units mu = 1: start on the circular orbit r = 1 at (1, 0)
    with v = (0, 1); finish on the circular orbit r = 1.5 (radius,
    tangential-flight and circular-speed boundary rows; phase free). Thrust
    magnitude path-constrained: |u|^2 <= Tmax^2 with Tmax = 0.1; the tf
    deadline 11.0 pins the revolution count of the local optimum."""
    mu = 1.0
    rf = 1.5
    tmax = 0.1
    eps = 1e-3  # L1 smoothing |u| ~ sqrt(u.u + eps^2) - eps

    def dyn(t, x, u, v):
        px, py, vx, vy = x[0], x[1], x[2], x[3]
        r3 = (px**2 + py**2) ** 1.5
        return torch.stack([vx, vy, -mu * px / r3 + u[0], -mu * py / r3 + u[1]])

    pre = PreOCP("orbit_transfer")
    pre.state(4).control(2).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(
        lagrange=lambda t, x, u, v: torch.sqrt(u[0] ** 2 + u[1] ** 2 + eps**2) - eps
    )
    pre.variable_bounds(lb=[2.0], ub=[11.0])
    pre.path_constraint(
        lambda t, x, u, v: torch.stack([u[0] ** 2 + u[1] ** 2]),
        lb=[-np.inf],
        ub=[tmax**2],
    )
    pre.initial_state([1.0, 0.0, 0.0, 1.0])

    def final_orbit(x0, xf, v):
        px, py, vx, vy = xf[0], xf[1], xf[2], xf[3]
        return torch.stack(
            [
                px**2 + py**2 - rf**2,  # final radius
                px * vx + py * vy,  # no radial velocity
                vx**2 + vy**2 - mu / rf,  # circular speed
            ]
        )

    pre.boundary_constraint(final_orbit, lb=[0.0, 0.0, 0.0], ub=[0.0, 0.0, 0.0])

    # init: spiral outward over ~1.75 revolutions, tangential quarter-thrust
    tfi = 11.0

    def state0(t):
        s = t / tfi
        r = 1.0 + 0.5 * s
        ang = 2 * np.pi * 1.75 * s
        vmag = 1.0 / np.sqrt(r)
        return [
            r * np.cos(ang),
            r * np.sin(ang),
            -vmag * np.sin(ang),
            vmag * np.cos(ang),
        ]

    init = InitialGuess(state=state0, control=[0.0, 0.02], variable=[tfi])
    return Problem(pre.build(), 0.172258, "orbit_transfer", init=init)


@register
def swimmer2() -> Problem:
    """Alias of `swimmer`: the reference keeps a second dialect only because
    its Exa path needs component-wise dynamics; this framework has one
    transcription, so the variant is mathematically identical."""
    from ctdirect_tpu_torch.problems.vehicles import swimmer

    p = swimmer()
    return Problem(p.ocp, p.obj, "swimmer2", init=p.init)
