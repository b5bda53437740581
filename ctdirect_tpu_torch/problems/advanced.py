"""Advanced fixture problems (torch twins of `ctdirect_tpu.problems.advanced`:
algal_bacterial, glider, insurance, moonlander, bioreactor, bolza,
parametric, schlogl, electric_vehicle, quadrotor). Same formulas, bounds,
initial guesses, names and stored objectives; vectors are unpacked by
indexing and built with `torch.stack`, so the callables stay traceable by
`torch.func`."""

from __future__ import annotations

import math

import numpy as np
import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register


@register
def algal_bacterial() -> Problem:
    """Algal-bacterial consortium, obj 5.45."""
    s_in, beta, gamma = 0.5, 23e-3, 0.44
    dmax, phimax, ks = 1.5, 6.48, 0.09
    rhomax, kv = 27.3e-3, 0.57e-3
    mumax, qmin = 1.0211, 2.7628e-3
    x0 = np.array([0.1629, 0.0487, 0.0003, 0.0177, 0.035, 0.0])

    def dyn(t, x, u, v):
        s, e, vv, q, c = x[0], x[1], x[2], x[3], x[4]
        alpha, d = u[0], u[1]
        phi = phimax * s / (ks + s)
        rho = rhomax * vv / (kv + vv)
        mu = mumax * (1 - qmin / q)
        return torch.stack(
            [
                d * (s_in - s) - phi * e / gamma,
                ((1 - alpha) * phi - d) * e,
                alpha * beta * phi * e - rho * c - d * vv,
                rho - mu * q,
                (mu - d) * c,
                d * c,
            ]
        )

    pre = PreOCP("algal_bacterial")
    pre.state(6).control(2)
    pre.time(t0=0.0, tf=20.0)
    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0_, xf, v: xf[5], maximize=True)
    pre.state_bounds(lb=[0, 0, 0, qmin, 0, 0])
    pre.control_bounds(lb=[0, 0], ub=[1.0, dmax])
    pre.initial_state(x0)
    return Problem(pre.build(), 5.45, "algal_bacterial")


@register
def glider() -> Problem:
    """COPS hang glider, max final range in a thermal; obj 1250."""
    u_c, r_0, mass, g = 2.5, 100.0, 100.0, 9.81
    c0, c1, S, rho = 0.034, 0.069662, 14.0, 1.13
    x_0, y_0, y_f = 0.0, 1000.0, 900.0
    vx_0, vy_0 = 13.23, -1.288

    def dyn(t, x, u, v):
        x1, vx, vy = x[0], x[2], x[3]
        cL = u[0]
        r = (x1 / r_0 - 2.5) ** 2
        UpD = u_c * (1 - r) * torch.exp(-r)
        w = vy - UpD
        vel = torch.sqrt(vx**2 + w**2)
        D = 0.5 * (c0 + c1 * cL**2) * rho * S * vel**2
        L = 0.5 * cL * rho * S * vel**2
        return torch.stack(
            [
                vx,
                vy,
                (-L * (w / vel) - D * (vx / vel)) / mass,
                (L * (vx / vel) - D * (w / vel)) / mass - g,
            ]
        )

    pre = PreOCP("glider")
    pre.state(4).control(1).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0_, xf, v: xf[0], maximize=True)
    pre.state_bounds(lb=[0.0, -np.inf, 0.0, -np.inf])
    pre.control_bounds(lb=[0.0], ub=[1.4])
    pre.variable_bounds(lb=[10.0])
    pre.initial_state([x_0, y_0, vx_0, vy_0])
    pre.final_state([y_f, vx_0, vy_0], rg=[1, 2, 3])
    tf_guess = (y_f - y_0) / vy_0
    init = InitialGuess(
        state=lambda t: [x_0 + vx_0 * t, y_0 + t / tf_guess * (y_f - y_0), vx_0, vy_0],
        control=[0.7],
        variable=[tf_guess],
    )
    return Problem(pre.build(), 1.25e3, "glider", init=init)


@register
def insurance() -> Problem:
    """Bocop insurance (non-audit), obj 2.059511. Algebraic controls
    R, H, U, dUdR pinned by equality path constraints."""
    gamma, lam, h0, w, s_ = 0.2, 0.25, 1.5, 1.0, 10.0
    k, sigma, alpha, tf = 0.0, 0.0, 4.0, 10.0

    def fx(t):
        return lam * torch.exp(-lam * t) + math.exp(-lam * tf) / tf

    def dyn(t, x, u, v):
        I, m = x[0], x[1]
        h, dUdR = u[0], u[4]
        vprime = alpha / 2 * m ** (alpha / 2 - 1) / (1 + m ** (alpha / 2)) ** 2
        return torch.stack(
            [
                (1 - gamma * t * vprime / dUdR) * h,
                h,
                (1 + sigma) * I * fx(t),
            ]
        )

    def path(t, x, u, v):
        I, m = x[0], x[1]
        R, H, U, dUdR = u[1], u[2], u[3], u[4]
        eps = k * t / (tf - t + 1)
        vv = m ** (alpha / 2) / (1 + m ** (alpha / 2))
        return torch.stack(
            [
                R - (w - v[0] + I - m - eps),
                H - (h0 - gamma * t * (1 - vv)),
                U - (1 - torch.exp(-s_ * R) + H),
                dUdR - s_ * torch.exp(-s_ * R),
            ]
        )

    pre = PreOCP("insurance")
    pre.state(3).control(5).variable(1)
    pre.time(t0=0.0, tf=tf)
    pre.dynamics(dyn)
    pre.objective(lagrange=lambda t, x, u, v: u[3] * fx(t), maximize=True)
    pre.state_bounds(lb=[0, 0, -np.inf], ub=[1.1, 1.1, np.inf])
    pre.control_bounds(lb=[0, 0, 0, 0, 1e-8], ub=[25, np.inf, np.inf, np.inf, np.inf])
    pre.variable_bounds(lb=[0.0])
    pre.path_constraint(path, lb=[0.0] * 4, ub=[0.0] * 4)
    pre.initial_state([0.0, 0.001, 0.0])
    pre.boundary_constraint(lambda x0_, xf, v: v[0] - xf[2], lb=[0.0], ub=[0.0])
    return Problem(pre.build(), 2.059511, "insurance")


@register
def moonlander(p_f=(5.0, 5.0)) -> Problem:
    """Min-time planar moonlander, obj 0.962."""
    mass, g, I, Dd = 1.0, 9.81, 0.1, 1.0
    max_thrust = 2 * g

    def dyn(t, x, u, v):
        dp1, dp2, theta, dtheta = x[2], x[3], x[4], x[5]
        F1, F2 = u[0], u[1]
        Ft = F1 + F2
        ddp1 = (-torch.sin(theta) * Ft) / mass
        ddp2 = (torch.cos(theta) * Ft) / mass - g
        ddtheta = (1 / I) * (Dd / 2) * (F2 - F1)
        return torch.stack([dp1, dp2, ddp1, ddp2, dtheta, ddtheta])

    pre = PreOCP("moonlander")
    pre.state(6).control(2).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0_, xf, v: v[0])
    pre.control_bounds(lb=[0.0, 0.0], ub=[max_thrust, max_thrust])
    pre.variable_bounds(lb=[0.1])
    pre.initial_state([0.0] * 6)
    pre.final_state([p_f[0], p_f[1], 0.0, 0.0], rg=[0, 1, 2, 3])
    return Problem(
        pre.build(), 9.62e-1, "moonlander", init=InitialGuess(control=[5.0, 5.0])
    )


def _bioreactor_dynamics():
    beta, c, gamma = 1.0, 2.0, 1.0
    Ks, mu2m, mubar, r = 0.05, 0.1, 1.0, 0.005
    halfperiod = 5.0

    def light(time):
        days = time / (halfperiod * 2)
        tau = (days - torch.floor(days)) * 2 * math.pi
        return torch.clamp(torch.sin(tau), min=0.0) ** 2

    def dyn(t, x, u, v):
        y, s, b = x[0], x[1], x[2]
        mu = light(t) * mubar
        mu2 = mu2m * s / (s + Ks)
        return torch.stack(
            [
                mu * y / (1 + y) - (r + u[0]) * y,
                -mu2 * b + u[0] * beta * (gamma * y - s),
                (mu2 - u[0] * beta) * b,
            ]
        )

    def lag(t, x, u, v):
        s, b = x[1], x[2]
        mu2 = mu2m * s / (s + Ks)
        return mu2 * b / (beta + c)

    return dyn, lag


@register
def bioreactor_1day() -> Problem:
    """Day/night methane bioreactor, 1-day periodic; obj 0.614134."""
    dyn, lag = _bioreactor_dynamics()
    pre = PreOCP("bioreactor_1day")
    pre.state(3).control(1)
    pre.time(t0=0.0, tf=10.0)
    pre.dynamics(dyn)
    pre.objective(lagrange=lag, maximize=True)
    pre.state_bounds(lb=[0.0, 0.0, 0.001])
    pre.control_bounds(lb=[0.0], ub=[1.0])
    # 1 <= y(0), 1 <= b(0); periodicity x(0) == x(T)
    pre.boundary_constraint(
        lambda x0_, xf, v: torch.stack([x0_[0], x0_[2]]), lb=[1.0, 1.0], ub=[np.inf, np.inf]
    )
    pre.boundary_constraint(
        lambda x0_, xf, v: x0_ - xf, lb=[0.0] * 3, ub=[0.0] * 3
    )
    return Problem(pre.build(), 0.614134, "bioreactor_1day")


@register
def bioreactor_Ndays(days: int = 30) -> Problem:
    """Non-periodic N-day bioreactor; obj 19.0745 at N=30."""
    dyn, lag = _bioreactor_dynamics()
    pre = PreOCP("bioreactor_Ndays")
    pre.state(3).control(1)
    pre.time(t0=0.0, tf=10.0 * days)
    pre.dynamics(dyn)
    pre.objective(lagrange=lag, maximize=True)
    pre.state_bounds(lb=[0.0, 0.0, 0.001])
    pre.control_bounds(lb=[0.0], ub=[1.0])
    pre.boundary_constraint(
        lambda x0_, xf, v: x0_,
        lb=[0.05, 0.5, 0.5],
        ub=[0.25, 5.0, 3.0],
    )
    obj = 19.0745 if days == 30 else None
    return Problem(
        pre.build(), obj, "bioreactor_Ndays", init=InitialGuess(state=[50.0, 50.0, 50.0])
    )


@register
def bolza_freetf() -> Problem:
    """Bolza cost with free tf entering the dynamics; obj 1.476."""
    pre = PreOCP("bolza_freetf")
    pre.state(1).control(1).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(lambda t, x, u, v: torch.stack([v[0] * u[0]]))
    pre.objective(
        mayer=lambda x0_, xf, v: v[0],
        lagrange=lambda t, x, u, v: 0.5 * u[0] ** 2,
    )
    pre.state_bounds(lb=[0.0])
    pre.variable_bounds(lb=[0.1])
    pre.initial_state([0.0]).final_state([1.0])
    return Problem(pre.build(), 1.476, "bolza_freetf")


@register
def parametric(rho: float = 1.0) -> Problem:
    """Parametric time-reallocation problem; obj -0.336 at rho=1."""
    mu, T = 10.0, 2.0

    def m(x):
        return torch.log(torch.abs(1 + torch.exp(mu * (1 - x)))) / mu

    pre = PreOCP("parametric")
    pre.state(2).control(2).variable(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(
        lambda t, x, u, v: torch.stack([v[0] * (u[0] + 2), (T - v[0]) * u[1]])
    )
    # the reference minimizes -(x2(1)-2)^3 - int(rho*(...)): keep the min sense
    pre.objective(
        mayer=lambda x0_, xf, v: -((xf[1] - 2.0) ** 3),
        lagrange=lambda t, x, u, v: -rho
        * (v[0] * m(x[0]) ** 2 + (T - v[0]) * m(x[1]) ** 2),
    )
    pre.control_bounds(lb=[-1.0, -1.0], ub=[1.0, 1.0])
    pre.variable_bounds(lb=[0.0], ub=[T])
    pre.initial_state([0.0, 1.0])
    pre.final_state([1.0], rg=[0])
    obj = -3.36e-1 if rho == 1.0 else None
    return Problem(pre.build(), obj, "parametric")


@register
def schlogl() -> Problem:
    """Schlogl reaction-network control; no stored objective. The fourth
    term's `- (u0 - k2 xx^2)` is the JAX package's as written (the pattern
    of the other terms suggests u2)."""
    k0, k1, k2, k3 = 6.0, 11.0, 6.0, 1.0

    def lag(t, x, u, v):
        xx = x[0]
        u0, u1, u2, u3 = u[0], u[1], u[2], u[3]
        return (
            u0 * torch.log(torch.abs(u0 / k0))
            - (u0 - k0)
            + u1 * torch.log(torch.abs(u1 / (k1 * xx)))
            - (u1 - k1 * xx)
            + u2 * torch.log(torch.abs(u2 / (k2 * xx**2)))
            - (u0 - k2 * xx**2)
            + u3 * torch.log(torch.abs(u3 / (k3 * xx**3)))
            - (u3 - k3 * xx**3)
        )

    pre = PreOCP("schlogl")
    pre.state(1).control(4).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(lambda t, x, u, v: torch.stack([u[0] - u[1] + u[2] - u[3]]))
    pre.objective(lagrange=lag)
    pre.state_bounds(lb=[0.5])
    pre.control_bounds(lb=[0.1] * 4)
    pre.variable_bounds(lb=[0.02], ub=[1.0])
    pre.initial_state([1.0]).final_state([2.0])
    return Problem(pre.build(), None, "schlogl")


@register
def electric_vehicle() -> Problem:
    """Petit-Sciarretta electric vehicle; obj 1.23e6."""
    tf, D = 1.0, 10.0
    b1, b2 = 1e3, 1e3
    h0, h1, h2 = 0.1, 1.0, 1e-3
    p0, p1, p2, p3 = 3.0, 0.4, -1.0, 0.1

    def dyn(t, x, u, v):
        pos, vel = x[0], x[1]
        road = p0 + p1 * pos + p2 * pos**2 + p3 * pos**3
        return torch.stack([vel, h1 * u[0] - h2 * vel**2 - h0 - road])

    pre = PreOCP("electric_vehicle")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=tf)
    pre.dynamics(dyn)
    pre.objective(lagrange=lambda t, x, u, v: b1 * u[0] * x[1] + b2 * u[0] ** 2)
    pre.state_bounds(lb=[0.0, 0.0])
    pre.initial_state([0.0, 0.0])
    pre.final_state([D, 0.0])
    init = InitialGuess(
        state=lambda t: [(t / tf) * D, 1.0],
        control=[0.5],
    )
    return Problem(pre.build(), 1.23e6, "electric_vehicle", init=init)


@register
def quadrotor() -> Problem:
    """Min-time quadrotor point-to-point with a tilt path bound."""
    g = 9.81
    atmax = 9.18 * 5
    tiltmax, dtiltmax = 1.1 / 2, 6.0 / 2
    p0 = [0.0, 0.0, 2.5]
    pf = [0.01, 5.0, 2.5]

    def dyn(t, x, u, v):
        v1, v2, v3, phi, theta = x[3], x[4], x[5], x[6], x[7]
        at, phi_dot, theta_dot, psi = u[0], u[1], u[2], u[3]
        cr, sr = torch.cos(phi), torch.sin(phi)
        cp, sp = torch.cos(theta), torch.sin(theta)
        cy, sy = torch.cos(psi), torch.sin(psi)
        a1 = (cy * sp * cr + sy * sr) * at
        a2 = (sy * sp * cr - cy * sr) * at
        a3 = cp * cr * at - g
        return torch.stack([v1, v2, v3, a1, a2, a3, phi_dot, theta_dot])

    pre = PreOCP("quadrotor")
    pre.state(8).control(4).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0_, xf, v: v[0])
    pre.state_bounds(
        lb=[-np.inf] * 6 + [-np.pi / 2, -np.pi / 2],
        ub=[np.inf] * 6 + [np.pi / 2, np.pi / 2],
    )
    pre.control_bounds(
        lb=[0.0, -dtiltmax, -dtiltmax, -np.inf],
        ub=[atmax, dtiltmax, dtiltmax, np.inf],
    )
    pre.variable_bounds(lb=[0.1])
    pre.path_constraint(
        lambda t, x, u, v: torch.cos(x[7]) * torch.cos(x[6]),
        lb=[np.cos(tiltmax)],
        ub=[np.inf],
    )
    pre.initial_state(p0 + [0.0, 0.0, 0.0, 0.0, 0.0])
    pre.final_state(pf + [0.0, 0.0, 0.0], rg=[0, 1, 2, 3, 4, 5])
    return Problem(pre.build(), None, "quadrotor")
