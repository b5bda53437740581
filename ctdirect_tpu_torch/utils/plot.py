"""Optional matplotlib plotting helpers (PyTorch port of
`ctdirect_tpu.utils.plot`). A Solution's trajectories are host numpy, so this
is numpy plus matplotlib, imported lazily: the package has no hard
dependency on it."""

from __future__ import annotations

import numpy as np


def plot_solution(sol, components=None, show=False, path=None):
    """Plot state / control / costate trajectories of a Solution.

    Returns the matplotlib Figure. `components`: optional dict with keys
    'state'/'control'/'costate' listing component indices to plot."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    comp = components or {}
    t = np.linspace(sol.time_grid[0], sol.time_grid[-1], 400)
    rows = 2 + (1 if sol.ocp.m > 0 else 0)
    fig, axes = plt.subplots(rows, 1, figsize=(8, 2.6 * rows), sharex=True)
    axes = np.atleast_1d(axes)

    X = sol.state(t)
    for j in comp.get("state", range(sol.ocp.n)):
        axes[0].plot(t, X[:, j], label=f"x{j+1}")
    axes[0].set_ylabel("state")
    axes[0].legend(loc="best", fontsize=8)

    k = 1
    if sol.ocp.m > 0:
        U = sol.control(t)
        for j in comp.get("control", range(sol.ocp.m)):
            axes[k].plot(t, U[:, j], label=f"u{j+1}", drawstyle="steps-post")
        axes[k].set_ylabel("control")
        axes[k].legend(loc="best", fontsize=8)
        k += 1

    Pv = sol.costate(t)
    for j in comp.get("costate", range(sol.ocp.n)):
        axes[k].plot(t, Pv[:, j], label=f"p{j+1}")
    axes[k].set_ylabel("costate")
    axes[k].set_xlabel("t")
    axes[k].legend(loc="best", fontsize=8)

    fig.suptitle(
        f"{sol.ocp.name}: objective {sol.objective:.6g} "
        f"({sol.iterations} iter, {sol.message})"
    )
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    if show:
        plt.show()
    return fig
