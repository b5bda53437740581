"""Declarative OCP front end: `define(...)` — one call, whole problem
(PyTorch port of `ctdirect_tpu.model.define`).

A single keyword-argument call carries what a `@def ... end` block of the
modelling language carries, and lowers onto `PreOCP`. Callables
are torch (build vectors with `torch.stack`).

Example — the Goddard problem::

    ocp = define(
        "goddard",
        state=3, control=1, variable=1,
        t0=0.0, tf="v[0]",                     # free final time via v
        dynamics=f,                            # f(t, x, u, v) -> (3,)
        mayer=lambda x0, xf, v: xf[0], maximize=True,
        state_bounds=([1.0, 0.0, 0.6], [None, None, 1.0]),
        control_bounds=(0.0, 1.0),
        variable_bounds=(0.01, None),
        initial_state=[1.0, 0.0, 1.0],
        final_state={"rg": [2], "value": [0.6]},
        path={"f": gcons, "lb": [0.0], "ub": [np.inf]},
    )

`tf`/`t0` accept a float (fixed) or the string "v[k]" (free, stored at v[k]).
Bounds accept scalars (broadcast), lists (None entries = unbounded), or None.
`path`/`boundary` accept one dict or a list of dicts {f, lb, ub}.
`initial_state`/`final_state` accept a full vector or {"rg": idx, "value": vals}.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from ctdirect_tpu_torch.model.ocp import OCP, PreOCP

_VIDX = re.compile(r"^\s*v\[(\d+)\]\s*$")


def _time_arg(val, label):
    """float -> fixed; 'v[k]' -> free index k."""
    if isinstance(val, str):
        m = _VIDX.match(val)
        if not m:
            raise ValueError(f"{label} must be a float or 'v[k]', got {val!r}")
        return None, int(m.group(1))
    if val is None:
        raise ValueError(f"{label} is required (float or 'v[k]')")
    return float(val), None


def _expand(side, dim, fill):
    """scalar | list-with-Nones | None -> bounds vector or None."""
    if side is None:
        return None
    if np.isscalar(side):
        return np.full((dim,), float(side))
    return np.array([fill if x is None else float(x) for x in side])


def _apply_bounds(setter, spec, dim):
    if spec is None:
        return
    if isinstance(spec, dict):
        setter(lb=spec.get("lb"), ub=spec.get("ub"), rg=spec.get("rg"))
        return
    lb, ub = spec
    setter(lb=_expand(lb, dim, -np.inf), ub=_expand(ub, dim, np.inf))


def _apply_pin(pin_fn, spec):
    if spec is None:
        return
    if isinstance(spec, dict):
        pin_fn(spec["value"], rg=spec.get("rg"))
    else:
        pin_fn(spec)


def define(
    name: str = "ocp",
    *,
    state: int,
    control: int = 0,
    variable: int = 0,
    t0=0.0,
    tf=None,
    dynamics,
    lagrange=None,
    mayer=None,
    maximize: bool = False,
    state_bounds=None,
    control_bounds=None,
    variable_bounds=None,
    initial_state=None,
    final_state=None,
    path=None,
    boundary=None,
) -> OCP:
    """Build an OCP declaratively in one call (see module docstring)."""
    pre = PreOCP(name)
    pre.state(state)
    if control:
        pre.control(control)
    else:
        pre.control(0)
    if variable:
        pre.variable(variable)

    t0_val, t0_idx = _time_arg(t0, "t0")
    tf_val, tf_idx = _time_arg(tf, "tf")
    pre.time(t0=t0_val, t0_index=t0_idx, tf=tf_val, tf_index=tf_idx)

    pre.dynamics(dynamics)
    pre.objective(mayer=mayer, lagrange=lagrange, maximize=maximize)

    _apply_bounds(pre.state_bounds, state_bounds, state)
    if control:
        _apply_bounds(pre.control_bounds, control_bounds, control)
    if variable:
        _apply_bounds(pre.variable_bounds, variable_bounds, variable)

    _apply_pin(pre.initial_state, initial_state)
    _apply_pin(pre.final_state, final_state)

    for entry, adder in ((path, pre.path_constraint), (boundary, pre.boundary_constraint)):
        if entry is None:
            continue
        entries = entry if isinstance(entry, (list, tuple)) else [entry]
        for e in entries:
            adder(e["f"], lb=e["lb"], ub=e["ub"])

    return pre.build()
