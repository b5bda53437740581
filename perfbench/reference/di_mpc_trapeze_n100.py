"""The equations of the configuration di_mpc_trapeze_n100: the min-energy
double integrator, x' = (x2, u), running cost u^2. Its numbers are in
perfbench/configs/di_mpc_trapeze_n100.json."""

import torch


def dynamics(x, u, cfg):
    return torch.stack([x[1], u[0]])


def lagrange(x, u, cfg):
    return u[0] ** 2
