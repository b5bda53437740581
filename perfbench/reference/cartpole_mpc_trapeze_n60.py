"""The equations of the configuration cartpole_mpc_trapeze_n60: the
cart-pole (Kelly 2017, section 6 and appendix E; theta = 0 hanging down),
states (x, dx, theta, dtheta), control the force on the cart, running cost
u^2. Its numbers are in perfbench/configs/cartpole_mpc_trapeze_n60.json."""

import torch


def dynamics(x, u, cfg):
    p = cfg["problem"]
    mc, mp, l, g = p["cart_mass"], p["pole_mass"], p["pole_length"], p["gravity"]
    dx, th, dth = x[1], x[2], x[3]
    sth, cth = torch.sin(th), torch.cos(th)
    denom = mc + mp * sth**2
    ddx = (u[0] + mp * sth * (l * dth**2 + g * cth)) / denom
    ddth = (-u[0] * cth - mp * l * dth**2 * cth * sth - (mc + mp) * g * sth) / (l * denom)
    return torch.stack([dx, ddx, dth, ddth])


def lagrange(x, u, cfg):
    return u[0] ** 2
