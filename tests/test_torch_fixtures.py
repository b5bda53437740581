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

from torch_helpers import TOL, assert_same_calls, assert_same_spec

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


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_jax(name):
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    pj, pt = problem_j(name), problem_t(name)
    assert (pt.obj, pt.name) == (pj.obj, pj.name)
    assert (pt.init is None) == (pj.init is None)
    assert_same_spec(pt.ocp, pj.ocp)
    assert_same_calls(pt.ocp, pj.ocp)
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
    assert_same_spec(ot, built)
    assert_same_calls(ot, problem_j("goddard").ocp)
    assert_same_spec(ot, oj)
    assert_same_calls(ot, oj)


def test_define_rejects_a_bad_time_spec():
    import ctdirect_tpu_torch as ct

    with pytest.raises(ValueError, match="v\\[k\\]"):
        ct.define(state=1, tf="tf", dynamics=lambda t_, x, u, v: x)
    with pytest.raises(ValueError, match="required"):
        ct.define(state=1, dynamics=lambda t_, x, u, v: x)
