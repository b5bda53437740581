"""Fixture library parity: every fixture of `problems/basic.py`, `goddard.py`
and `misc.py` in the port against the JAX package's (float64, CPU). The
callables are evaluated at the same numpy-seeded points; they are the same
formulas, so they agree at rounding level (1e-12). Bounds, initial guesses
and reference objectives must be equal. `define(...)` is checked against the
`PreOCP` construction it lowers onto."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import box_sample, n

TOL = 1e-12

FIXTURES = [
    "double_integrator_mintf",
    "double_integrator_freet0tf",
    "double_integrator_nobounds",
    "beam",
    "fuller",
    "vanderpol",
    "jackson",
    "robbins",
    "simple_integrator",
    "goddard",
    "goddard_all",
    "estimate_initial_condition",
    "estimate_rotation_rate",
    "pattern",
    "action",
]


def _points(ocp, seed):
    rng = np.random.default_rng(seed)
    return dict(
        t=rng.uniform(0.0, 1.0),
        x=box_sample(rng, ocp.x_lb, ocp.x_ub),
        xf=box_sample(rng, ocp.x_lb, ocp.x_ub),
        u=box_sample(rng, ocp.u_lb, ocp.u_ub),
        v=box_sample(rng, ocp.v_lb, ocp.v_ub),
    )


def _calls(ocp, p, arr):
    """Every callable of an OCP evaluated at the point p (arrays built by arr)."""
    tt, x, xf, u, v = (arr(p[k]) for k in ("t", "x", "xf", "u", "v"))
    out = {"dynamics": ocp.dynamics(tt, x, u, v)}
    if ocp.lagrange is not None:
        out["lagrange"] = ocp.lagrange(tt, x, u, v)
    if ocp.mayer is not None:
        out["mayer"] = ocp.mayer(x, xf, v)
    if ocp.path is not None:
        out["path"] = ocp.path(tt, x, u, v)
    if ocp.boundary is not None:
        out["boundary"] = ocp.boundary(x, xf, v)
    return out


def _assert_same_spec(ot, oj):
    assert (ot.n, ot.m, ot.q, ot.maximize, ot.name) == (oj.n, oj.m, oj.q, oj.maximize, oj.name)
    assert (ot.n_path, ot.n_boundary, ot.has_lagrange, ot.has_mayer) == (
        oj.n_path, oj.n_boundary, oj.has_lagrange, oj.has_mayer)
    ts = lambda o: (o.time.t0, o.time.tf, o.time.t0_index, o.time.tf_index)  # noqa: E731
    assert ts(ot) == ts(oj)
    for attr in ("x_lb", "x_ub", "u_lb", "u_ub", "v_lb", "v_ub", "path_lb", "path_ub",
                 "boundary_lb", "boundary_ub"):
        a, b = getattr(ot, attr), getattr(oj, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=attr)


def _assert_same_calls(ot, oj, seeds=(0, 1, 2)):
    for seed in seeds:
        p = _points(oj, seed)
        ct = _calls(ot, p, lambda a: torch.tensor(np.asarray(a), dtype=torch.float64))
        cj = _calls(oj, p, lambda a: jnp.asarray(a, dtype=jnp.float64))
        assert ct.keys() == cj.keys()
        for key in cj:
            np.testing.assert_allclose(n(ct[key]), np.asarray(cj[key]), rtol=TOL, atol=TOL,
                                       err_msg=f"{key}, seed {seed}")


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_jax(name):
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    pj, pt = problem_j(name), problem_t(name)
    assert (pt.obj, pt.name) == (pj.obj, pj.name)
    assert (pt.init is None) == (pj.init is None)
    _assert_same_spec(pt.ocp, pj.ocp)
    _assert_same_calls(pt.ocp, pj.ocp)
    # the initial guess, packed on a grid (callable inits are evaluated there)
    dj = transcribe_j(pj.ocp, grid_size=8, scheme="trapeze")
    dt = transcribe_t(pt.ocp, grid_size=8, scheme="trapeze", device="cpu")
    np.testing.assert_allclose(dt.initial_guess(pt.init), dj.initial_guess(pj.init), rtol=0, atol=TOL)


def test_registry_covers_the_jax_fixture_modules():
    """Every fixture of basic.py, goddard.py and misc.py is registered."""
    from ctdirect_tpu_torch.problems import problem_names

    assert set(FIXTURES) | {"double_integrator_minenergy"} <= set(problem_names())


def _goddard_by_define(define, stack, exp):
    Cd, beta, b, Tmax = 310.0, 500.0, 2.0, 3.5

    def dyn(t_, x, u, v):
        r, vel, m = x[0], x[1], x[2]
        D = Cd * vel**2 * exp(-beta * (r - 1.0))
        return stack([vel, -D / m - 1.0 / r**2 + u[0] * Tmax / m, -b * Tmax * u[0]])

    return define(
        "goddard",
        state=3, control=1, variable=1,
        t0=0.0, tf="v[0]",
        dynamics=dyn,
        mayer=lambda x0, xf, v: xf[0], maximize=True,
        state_bounds=([1.0, 0.0, 0.6], [1.1, 0.1, 1.0]),
        control_bounds=(0.0, 1.0),
        variable_bounds=(0.01, None),
        initial_state=[1.0, 0.0, 1.0],
        final_state={"rg": [2], "value": [0.6]},
    )


def test_define_matches_the_preocp_goddard():
    """define(...) lowers onto the same OCP as the PreOCP goddard fixture, in
    the port and in the JAX package alike."""
    import ctdirect_tpu as cj
    import ctdirect_tpu_torch as ctt
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    ot = _goddard_by_define(ctt.define, torch.stack, torch.exp)
    oj = _goddard_by_define(cj.define, jnp.array, jnp.exp)
    built = problem_t("goddard").ocp
    _assert_same_spec(ot, built)
    _assert_same_calls(ot, problem_j("goddard").ocp)
    _assert_same_spec(ot, oj)
    _assert_same_calls(ot, oj)


def test_define_rejects_a_bad_time_spec():
    import ctdirect_tpu_torch as ct

    with pytest.raises(ValueError, match="v\\[k\\]"):
        ct.define(state=1, tf="tf", dynamics=lambda t_, x, u, v: x)
    with pytest.raises(ValueError, match="required"):
        ct.define(state=1, dynamics=lambda t_, x, u, v: x)
