"""Fixture library parity, the rest: every fixture of `problems/advanced.py`,
`vehicles.py` and `mpc_fixtures.swimmer2` in the port against the JAX
package's (float64, CPU).

- The callables agree at rounding level (1e-12) at numpy-seeded points, and
  at t = 0 (the bioreactor's light has a tie of sin there) and t = 2.5 /
  7.5 (its day and night halves).
- Bounds, initial guesses on a grid, names and stored objectives are equal.
- The DOCP objective, constraints and constraint Jacobian at a seeded z on
  the trapeze grid N=6 agree to 1e-10 relative.
- For the slice as a whole: a cold `solve_docp` of `bolza_freetf`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import TOL, assert_same_calls, assert_same_spec, box_sample, n

ADVANCED = [
    "algal_bacterial",
    "glider",
    "insurance",
    "moonlander",
    "bioreactor_1day",
    "bioreactor_Ndays",
    "bolza_freetf",
    "parametric",
    "schlogl",
    "electric_vehicle",
    "quadrotor",
]
VEHICLES = ["space_shuttle", "truck_trailer", "swimmer"]
FIXTURES = ADVANCED + VEHICLES + ["swimmer2"]
TIMES = (0.0, 2.5, 7.5)
DOCP_RTOL = 1e-10


def _pair(name, **kw):
    from ctdirect_tpu.problems import _REGISTRY as reg_j
    from ctdirect_tpu_torch.problems import _REGISTRY as reg_t

    return reg_j[name](**kw), reg_t[name](**kw)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_jax(name):
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu_torch import transcribe as transcribe_t

    pj, pt = _pair(name)
    assert (pt.obj, pt.name) == (pj.obj, pj.name)
    assert (pt.init is None) == (pj.init is None)
    assert_same_spec(pt.ocp, pj.ocp)
    assert_same_calls(pt.ocp, pj.ocp, times=TIMES)
    dj = transcribe_j(pj.ocp, grid_size=8, scheme="trapeze")
    dt = transcribe_t(pt.ocp, grid_size=8, scheme="trapeze", device="cpu")
    np.testing.assert_allclose(dt.initial_guess(pt.init), dj.initial_guess(pj.init), rtol=0, atol=TOL)


@pytest.mark.parametrize(
    "name,kw",
    [("moonlander", dict(p_f=(4.0, 6.0))), ("bioreactor_Ndays", dict(days=3)),
     ("parametric", dict(rho=0.5)), ("swimmer", dict(tf=20.0))],
)
def test_fixture_arguments_match_jax(name, kw):
    """The fixture arguments, including those that drop the stored objective
    (obj None away from the reference's value)."""
    pj, pt = _pair(name, **kw)
    assert pt.obj == pj.obj
    assert_same_spec(pt.ocp, pj.ocp)
    assert_same_calls(pt.ocp, pj.ocp, seeds=(5,), times=(3.0,))


@pytest.mark.parametrize("name", FIXTURES)
def test_docp_matches_jax(name):
    """Objective, constraints and constraint Jacobian of the trapeze DOCP at
    N=6, at a seeded z inside the variable box."""
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu_torch import transcribe as transcribe_t

    pj, pt = _pair(name)
    dj = transcribe_j(pj.ocp, grid_size=6, scheme="trapeze")
    dt = transcribe_t(pt.ocp, grid_size=6, scheme="trapeze", device="cpu")
    np.testing.assert_array_equal(dt._z_lb, dj._z_lb)
    np.testing.assert_array_equal(dt._c_ub, dj._c_ub)
    z = box_sample(np.random.default_rng(0), dj._z_lb, dj._z_ub)
    zj, zt = jnp.asarray(z), torch.tensor(z, dtype=torch.float64)
    got = dict(objective=dt.objective(zt), constraints=dt.constraints(zt),
               jacobian=torch.func.jacfwd(dt.constraints)(zt))
    # jitted: op by op the JAX Jacobian takes seconds per fixture
    want = dict(objective=jax.jit(dj.objective)(zj), constraints=jax.jit(dj.constraints)(zj),
                jacobian=jax.jit(jax.jacfwd(dj.constraints))(zj))
    for key, ref in want.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(n(got[key]), ref, rtol=DOCP_RTOL,
                                   atol=DOCP_RTOL * max(1.0, np.abs(ref).max()), err_msg=key)


def test_purcell_matrix_matches_jax():
    from ctdirect_tpu.problems.vehicles import _purcell_g as g_j
    from ctdirect_tpu_torch.problems.vehicles import _purcell_g as g_t

    rng = np.random.default_rng(3)
    for th, b1, b3 in rng.uniform(-1.5, 1.5, (4, 3)):
        got = g_t(*(torch.tensor(a, dtype=torch.float64) for a in (th, b1, b3)))
        assert got.shape == (3, 2)
        np.testing.assert_allclose(n(got), np.asarray(g_j(*(jnp.float64(a) for a in (th, b1, b3)))),
                                   rtol=TOL, atol=TOL)


def test_problem_names_match_jax():
    from ctdirect_tpu.problems import problem_names as names_j
    from ctdirect_tpu_torch.problems import problem_names as names_t

    assert names_t() == names_j()
    assert set(FIXTURES) <= set(names_t())


def test_bolza_cold_solve_matches_jax():
    """The slice end to end: transcribe + IPM with the unbatched CR block
    solve (plain version on the CPU), cold start, trapeze N=20."""
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.solver.interface import solve_docp as solve_j
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu_torch import IPMOptions as OptsT
    from ctdirect_tpu_torch import solve_docp as solve_t
    from ctdirect_tpu_torch import transcribe as transcribe_t

    pj, pt = _pair("bolza_freetf")
    sj = solve_j(transcribe_j(pj.ocp, grid_size=20, scheme="trapeze"), init=pj.init,
                 options=OptsJ(tol=1e-8, kkt_mode="cr"))
    st = solve_t(transcribe_t(pt.ocp, grid_size=20, scheme="trapeze", device="cpu"), init=pt.init,
                 options=OptsT(tol=1e-8, kkt_mode="cr"))
    assert st.status == sj.status and st.successful
    np.testing.assert_allclose(st.objective, sj.objective, rtol=1e-8)
    np.testing.assert_allclose(st.objective, pt.obj, rtol=1e-2)
