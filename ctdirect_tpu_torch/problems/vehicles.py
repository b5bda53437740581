"""Vehicle-trajectory fixture problems (torch twins of
`ctdirect_tpu.problems.vehicles`: space_shuttle, truck_trailer, swimmer).

These are the hardest fixtures of the library: long horizons, strongly
nonlinear aerodynamic/kinematic models, free final time, and (shuttle) a
maximization objective over a 6-state entry model.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import PreOCP
from ctdirect_tpu_torch.problems import Problem, register

_D2R = np.pi / 180.0


@register
def space_shuttle() -> Problem:
    """Space-shuttle reentry, maximize crossrange latitude at TAEM (obj 34.18
    deg = 0.5966 rad, tf ~ 2009 s). States [h/1e5, lon, lat, v/1e4, fpa,
    azi], controls [angle-of-attack, bank], free tf in [1750, 2250]."""
    w, g0 = 203000.0, 32.174
    mass = w / g0
    rho0, hr, Re, mu, S = 0.002378, 23800.0, 20902900.0, 0.14076539e17, 2690.0
    a0, a1 = -0.20704, 0.029244
    b0, b1, b2 = 0.07854, -0.61592e-2, 0.621408e-3

    hs, vs = 2.6, 2.56
    gs, psis = -1.0 * _D2R, 90.0 * _D2R
    ht, vt, gt = 0.8, 0.25, -5.0 * _D2R

    def dyn(t, x, u, v):
        sh, lat, sv, gam, psi = x[0], x[2], x[3], x[4], x[5]
        alpha, beta = u[0], u[1]
        h = sh * 1e5
        vel = sv * 1e4
        ad = alpha / _D2R  # aero fits are in degrees
        cD = b0 + b1 * ad + b2 * ad**2
        cL = a0 + a1 * ad
        rho = rho0 * torch.exp(-h / hr)
        q = 0.5 * rho * vel**2
        D, L = cD * S * q, cL * S * q
        r = Re + h
        g = mu / r**2
        sg, cg = torch.sin(gam), torch.cos(gam)
        return torch.stack(
            [
                vel * sg / 1e5,
                (vel / r) * cg * torch.sin(psi) / torch.cos(lat),
                (vel / r) * cg * torch.cos(psi),
                (-(D / mass) - g * sg) / 1e4,
                (L / (mass * vel)) * torch.cos(beta) + cg * (vel / r - g / vel),
                L * torch.sin(beta) / (mass * vel * cg)
                + (vel / (r * torch.cos(lat))) * cg * torch.sin(psi) * torch.sin(lat),
            ]
        )

    pre = PreOCP("space_shuttle")
    pre.state(6).control(2).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0_, xf, v: xf[2], maximize=True)
    pre.state_bounds(
        lb=[0.0, -np.inf, -89 * _D2R, 0.0, -89 * _D2R, -np.inf],
        ub=[np.inf, np.inf, 89 * _D2R, np.inf, 89 * _D2R, np.inf],
    )
    pre.control_bounds(lb=[-90 * _D2R, -89 * _D2R], ub=[90 * _D2R, 1 * _D2R])
    pre.variable_bounds(lb=[1750.0], ub=[2250.0])
    pre.initial_state([hs, 0.0, 0.0, vs, gs, psis])
    pre.final_state([ht, vt, gt], rg=[0, 3, 4])

    tfi = 500.0
    init = InitialGuess(
        state=lambda t: [
            hs + t / tfi * (ht - hs),
            0.0,
            0.0,
            vs + t / tfi * (vt - vs),
            gs + t / tfi * (gt - gs),
            psis,
        ],
        control=[0.0, 0.0],
        variable=[tfi],
    )
    return Problem(pre.build(), 34.18 * _D2R, "space_shuttle", init=init)


@register
def truck_trailer() -> Problem:
    """Truck with two trailers, min time-plus-jackknife parking maneuver (obj
    59.28). States [x2, y2, th0, th1, th2, v0, delta0], controls [dv0,
    ddelta0], free tf."""
    L0, M0 = 0.4, 0.1
    L1, M1 = 1.1, 0.2
    L2 = 0.8

    def dyn(t, x, u, v):
        th0, th1, th2, v0, d0 = x[2], x[3], x[4], x[5], x[6]
        b01, b12 = th0 - th1, th1 - th2
        dth0 = v0 / L0 * torch.tan(d0)
        dth1 = v0 / L1 * torch.sin(b01) - M0 / L1 * torch.cos(b01) * dth0
        v1 = v0 * torch.cos(b01) + M0 * torch.sin(b01) * dth0
        dth2 = v1 / L2 * torch.sin(b12) - M1 / L2 * torch.cos(b12) * dth1
        v2 = v1 * torch.cos(b12) + M1 * torch.sin(b12) * dth1
        return torch.stack(
            [v2 * torch.cos(th2), v2 * torch.sin(th2), dth0, dth1, dth2, u[0], u[1]]
        )

    def betas(t, x, u, v):
        return torch.stack([x[2] - x[3], x[3] - x[4]])

    pre = PreOCP("truck_trailer")
    pre.state(7).control(2).variable(1)
    pre.time(t0=0.0, tf_index=0)
    pre.dynamics(dyn)
    pre.objective(
        mayer=lambda x0_, xf, v: v[0],
        lagrange=lambda t, x, u, v: (x[2] - x[3]) ** 2 + (x[3] - x[4]) ** 2,
    )
    hp = np.pi / 2
    pre.state_bounds(lb=[-hp, -hp], ub=[hp, hp], rg=[2, 3])
    pre.state_bounds(lb=[-0.2], ub=[0.2], rg=[5])
    pre.state_bounds(lb=[-np.pi / 6], ub=[np.pi / 6], rg=[6])
    pre.control_bounds(lb=[-1.0, -np.pi / 10], ub=[1.0, np.pi / 10])
    pre.variable_bounds(lb=[1.0], ub=[1000.0])
    pre.path_constraint(betas, lb=[-hp, -hp], ub=[hp, hp])
    pre.initial_state([0.0, 0.0, 0.0, 0.0, 0.0], rg=[0, 1, 2, 3, 4])
    pre.final_state([0.0, -2.0, hp], rg=[0, 1, 4])
    # final alignment: beta01(tf) = beta12(tf) = 0
    pre.boundary_constraint(
        lambda x0_, xf, v: torch.stack([xf[2] - xf[3], xf[3] - xf[4]]),
        lb=[0.0, 0.0],
        ub=[0.0, 0.0],
    )
    init = InitialGuess(variable=[10.0])
    return Problem(pre.build(), 59.28, "truck_trailer", init=init)


# The Bocop three-link microswimmer's grand-resistance matrix G (3x2) is a
# sum of sines and cosines of integer combinations of (theta, beta1, beta3).
# One row per angle k_th*theta + k_b1*beta1 + k_b3*beta3: its coefficient in
# the sine sums of g11 and g21, then in the cosine sums of g12, g22, aux and
# the numerators n13, n23 (the same terms as the JAX package's `_purcell_g`,
# evaluated as two small matrix products: a few launches per call instead of
# a few hundred, which the swimmer's derivatives multiply).
_PURCELL_TERMS = np.array([
    # k_th k_b1 k_b3 | g11  g21 (sin) | g12   g22  aux  n13  n23 (cos)
    [-1, 1, 0, -42, 8, -42, 8, 0, 0, 0],
    [-1, 2, 0, -2, 4, -2, 4, 0, 0, 0],
    [1, 0, 0, -24, 24, 24, -24, 0, 0, 0],
    [1, 1, 0, -300, 38, 300, -38, 0, 0, 0],
    [1, 2, 0, -12, 18, 12, -18, 0, 0, 0],
    [-1, 1, -2, -6, -2, -6, -2, 0, 0, 0],
    [-1, 2, -2, -1, -1, -1, -1, 0, 0, 0],
    [1, 0, -2, 4, -2, -4, 2, 0, 0, 0],
    [1, 1, -2, -12, 0, 12, 0, 0, 0, 0],
    [1, 2, -2, -1, -1, 1, 1, 0, 0, 0],
    [-1, 1, -1, 18, -54, 18, -54, 0, 0, 0],
    [-1, 2, -1, 0, -12, 0, -12, 0, 0, 0],
    [1, 0, -1, 8, -42, -8, 42, 0, 0, 0],
    [1, 1, -1, -54, 18, 54, -18, 0, 0, 0],
    [1, 2, -1, -2, -6, 2, 6, 0, 0, 0],
    [-1, 1, 1, -18, 18, -18, 18, 0, 0, 0],
    [-1, 2, 1, 0, 6, 0, 6, 0, 0, 0],
    [1, 0, 1, -38, 300, 38, -300, 0, 0, 0],
    [1, 1, 1, -90, 90, 90, -90, 0, 0, 0],
    [1, 2, 1, 0, 30, 0, -30, 0, 0, 0],
    [-1, 1, 2, -6, 0, -6, 0, 0, 0, 0],
    [1, 0, 2, -18, 12, 18, -12, 0, 0, 0],
    [1, 1, 2, -30, 0, 30, 0, 0, 0, 0],
    [0, 1, 0, 0, 0, 0, 0, 186, 186, 0],
    [0, 2, 0, 0, 0, 0, 0, 37, 2, -4],
    [0, 1, -2, 0, 0, 0, 0, 12, 12, 0],
    [0, 1, -1, 0, 0, 0, 0, 30, 30, 30],
    [0, 2, -2, 0, 0, 0, 0, 2, 1, 1],
    [0, 2, -1, 0, 0, 0, 0, 12, 0, 12],
    [0, 0, 1, 0, 0, 0, 0, 186, 0, 186],
    [0, 0, 2, 0, 0, 0, 0, 37, -4, 2],
    [0, 1, 1, 0, 0, 0, 0, -6, -6, -6],
    [0, 2, 2, 0, 0, 0, 0, -3, 0, 0],
    [0, 2, 1, 0, 0, 0, 0, -6, 0, -6],
    [0, 1, 2, 0, 0, 0, 0, -6, -6, 0],
], dtype=np.float64)
_PURCELL_CONST = np.array([0.0, 0.0, 543.0, 105.0, 105.0])  # cosine sums' constants
# G = [[g11, g21], [g12, g22], [g13, g23]]: numerator / (denominator * aux)
_PURCELL_DEN = np.array([4.0, 4.0, 4.0, 4.0, -2.0, -2.0])


@functools.lru_cache(maxsize=None)
def _purcell_tables(dtype: torch.dtype, device: torch.device) -> tuple:
    """The term table as tensors, once per dtype and device (read only)."""
    def as_t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (as_t(_PURCELL_TERMS[:, :3]), as_t(_PURCELL_TERMS[:, 3:5].T), as_t(_PURCELL_TERMS[:, 5:].T),
            as_t(_PURCELL_CONST), as_t(_PURCELL_DEN))


def _purcell_g(th, b1, b3):
    """Grand-resistance-matrix rows of the Bocop three-link microswimmer:
    dx/dt = g1·a, dy/dt = g2·a, dth/dt = g3·a for shape velocities
    a = (a1, a2). Returns the 3x2 matrix G.

    The term table `_PURCELL_TERMS` has no counterpart in the JAX package:
    it was derived by hand from the JAX `_purcell_g`, which writes every
    term out, and is checked against it at 1e-12
    (tests/test_torch_fixtures_more.py::test_purcell_matrix_matches_jax). The
    table only cuts host dispatch; the general remedy for that is to capture
    whole iterations in CUDA graphs (ROADMAP.md), not more such tables."""
    K, Ws, Wc, const, den = _purcell_tables(th.dtype, th.device)
    ang = K @ torch.stack([th, b1, b3])
    s = Ws @ torch.sin(ang)  # g11, g21 numerators
    c = Wc @ torch.cos(ang) + const  # g12, g22 numerators, aux, n13, n23
    num = torch.cat([s, c[:2], c[3:]])
    return (num / (den * c[2])).reshape(3, 2)


@register
def swimmer(tf: float = 25.0) -> Problem:
    """Bocop three-link Purcell microswimmer, maximize displacement x1(tf)
    (obj 0.984273 at tf=25). States [x, y, theta, beta1, beta3], controls =
    shape velocities (a1, a2)."""

    def dyn(t, x, u, v):
        G = _purcell_g(x[2], x[3], x[4])
        xyth_dot = G @ u
        return torch.cat([xyth_dot, u])

    pre = PreOCP("swimmer")
    pre.state(5).control(2)
    pre.time(t0=0.0, tf=float(tf))
    pre.dynamics(dyn)
    pre.objective(mayer=lambda x0_, xf, v: xf[0], maximize=True)
    pre.state_bounds(lb=[-3.15, -1.5, -1.5], ub=[3.15, 1.5, 1.5], rg=[2, 3, 4])
    pre.control_bounds(lb=[-1.0, -1.0], ub=[1.0, 1.0])
    pre.initial_state([0.0, 0.0], rg=[0, 1])
    # symmetry-breaking inequality boundary rows: -3.15 <= theta(0) <= 0,
    # 0 <= beta1(0)
    pre.boundary_constraint(
        lambda x0_, xf, v: torch.stack([x0_[2], x0_[3]]),
        lb=[-3.15, 0.0],
        ub=[0.0, np.inf],
    )
    pre.final_state([0.0], rg=[1])
    obj = 0.984273 if tf == 25.0 else None
    # 4-stroke periodic paddling init: selects the reference's solution basin
    # (the raw 0.1-constant init converges to a worse local max, obj 0.893)
    k = 2 * np.pi * 4.0 / float(tf)
    init = InitialGuess(control=lambda t: [np.cos(k * t), np.sin(k * t)])
    return Problem(pre.build(), obj, "swimmer", init=init)
