"""Schemes, strategies and the cart-pole / orbit fixtures: the port against the
JAX package on the same numpy-seeded inputs (float64, CPU). Same residual
programs, so agreement is at rounding level (1e-12; 1e-10 for the KKT blocks,
which sum in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import jax_docp, n, t, torch_docp

TOL = 1e-12

# (scheme, control_steps): midpoint with one and with two controls per step
SCHEME_CASES = [("midpoint", 1), ("midpoint", 2), ("euler", 1), ("euler_implicit", 1)]


def _pair(name, scheme, grid_size, control_steps=1):
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    dj = transcribe_j(problem_j(name).ocp, grid_size=grid_size, scheme=scheme,
                      control_steps=control_steps)
    dt = transcribe_t(problem_t(name).ocp, grid_size=grid_size, scheme=scheme,
                      control_steps=control_steps, device="cpu")
    return dj, dt


def _step_inputs(d, seed):
    """Random (X, U, t, h, v) of a DOCP's shapes."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((d.N + 1, d.n))
    U = rng.standard_normal((d.Nu, d.cs, d.m))
    tg = np.sort(rng.uniform(0.0, 2.0, d.N + 1))
    return X, U, tg, np.diff(tg), rng.standard_normal(d.q)


@pytest.mark.parametrize("scheme,cs", SCHEME_CASES)
def test_scheme_forms_match_jax(scheme, cs):
    """defects, quadrature, node_controls, control_times and the per-step
    local_residual / local_cost of the port's scheme == the JAX scheme's."""
    dj, dt = _pair("cartpole", scheme, 6, control_steps=cs)
    X, U, tg, h, v = _step_inputs(dj, seed=cs)
    sj, st = dj.scheme, dt.scheme
    assert (st.name, st.order, st.cs, st.u_rows(6)) == (sj.name, sj.order, sj.cs, sj.u_rows(6))
    jx = [jnp.asarray(a) for a in (X, U)]
    tx = [t(a) for a in (X, U)]
    Dj, _ = sj.defects(dj.fns, *jx, None, jnp.asarray(tg), jnp.asarray(h), jnp.asarray(v))
    Dt, S = st.defects(dt.fns, *tx, None, t(tg), t(h), t(v))
    assert S is None
    np.testing.assert_allclose(n(Dt), np.asarray(Dj), rtol=0, atol=TOL)
    qj = sj.quadrature(dj.fns, *jx, None, jnp.asarray(tg), jnp.asarray(h), jnp.asarray(v))
    qt = st.quadrature(dt.fns, *tx, None, t(tg), t(h), t(v))
    np.testing.assert_allclose(float(qt), float(qj), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(n(st.node_controls(tx[1])), np.asarray(sj.node_controls(jx[1])))
    np.testing.assert_array_equal(st.control_times(tg, h), sj.control_times(tg, h))
    for i in (0, 3):
        xn = X[i + 1]
        un = U[i + 1, 0] if sj.u_at_nodes else None
        args_j = (jnp.asarray(tg[i]), jnp.asarray(tg[i + 1]), jnp.asarray(X[i]), jnp.asarray(U[i]),
                  None, jnp.asarray(xn), None if un is None else jnp.asarray(un), jnp.asarray(v))
        args_t = (t(tg[i]), t(tg[i + 1]), t(X[i]), t(U[i]), None, t(xn),
                  None if un is None else t(un), t(v))
        np.testing.assert_allclose(n(st.local_residual(dt.fns, *args_t)),
                                   np.asarray(sj.local_residual(dj.fns, *args_j)), rtol=0, atol=TOL)
        np.testing.assert_allclose(float(st.local_cost(dt.fns, *args_t)),
                                   float(sj.local_cost(dj.fns, *args_j)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "alias,name,explicit",
    [("euler_explicit", "euler", True), ("euler_forward", "euler", True),
     ("euler_backward", "euler_implicit", False)],
)
def test_euler_aliases(alias, name, explicit):
    from ctdirect_tpu_torch.transcription.schemes import get_scheme

    s = get_scheme(alias)
    assert s.name == name and s.explicit is explicit


def _scalar_problem():
    """min ∫u², dx/dt = u, x(0)=0, x(1)=1 (tests/test_transcription.py)."""
    from ctdirect_tpu_torch import PreOCP

    pre = PreOCP("xsq")
    pre.state(1).control(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(lambda t_, x, u, v: torch.stack([u[0]]))
    pre.objective(lagrange=lambda t_, x, u, v: u[0] ** 2)
    pre.initial_state([0.0]).final_state([1.0])
    return pre.build()


@pytest.mark.parametrize("scheme", ["trapeze", "midpoint"])
def test_exact_feasible_residual(scheme):
    """x = t², u = 2t is exactly feasible; second-order schemes give zero
    defects (the port of tests/test_transcription.py::test_exact_feasible_residual
    for the ported ORDER2_SCHEMES)."""
    from ctdirect_tpu_torch import transcribe

    d = transcribe(_scalar_problem(), grid_size=7, scheme=scheme, device="cpu")
    tg = n(d.time_grid(t(np.zeros(0))))
    if scheme == "midpoint":  # the step control lives at the midpoint time
        ut = (0.5 * (tg[:-1] + tg[1:]))[:, None]
    else:
        ut = d.scheme.control_times(tg, np.diff(tg))
    z = d.pack(t((tg**2)[:, None]), t((2 * ut)[:, :, None]), None, t(np.zeros(0)))
    c = n(d.constraints(z))
    cl, cu = d.c_bounds
    eq = (cl == cu) & (cl == 0)
    np.testing.assert_allclose(c[eq], 0.0, atol=1e-12)
    np.testing.assert_allclose(c[d.boundary_row_indices()], [0.0, 1.0], atol=1e-12)


@pytest.mark.parametrize(
    "name,scheme",
    [("cartpole", "trapeze"), ("cartpole", "midpoint"), ("orbit_transfer", "midpoint"),
     ("orbit_transfer", "euler_implicit")],
)
def test_fixture_transcription_matches_jax(name, scheme):
    """cartpole / orbit_transfer at N=8: layout, bounds, initial guess and the
    NLP callbacks at random points."""
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    dj, dt = _pair(name, scheme, 8)
    pj, pt = problem_j(name), problem_t(name)
    assert pt.obj == pj.obj and pt.name == pj.name
    for attr in ("N", "n", "m", "q", "bw", "cw", "nz", "nc", "tail_w", "n_path", "n_boundary"):
        assert getattr(dt, attr) == getattr(dj, attr), attr
    for a, b in zip(dt.z_bounds + dt.c_bounds, dj.z_bounds + dj.c_bounds):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(dt.initial_guess(pt.init), dj.initial_guess(pj.init), rtol=0, atol=TOL)
    for seed in (0, 1):
        z = dj.initial_guess(pj.init) + 0.1 * np.random.default_rng(seed).standard_normal(dj.nz)
        np.testing.assert_allclose(n(dt.constraints(t(z))), np.asarray(dj.constraints(jnp.asarray(z))),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(float(dt.nlp_objective(t(z))), float(dj.nlp_objective(jnp.asarray(z))),
                                   rtol=TOL, atol=TOL)


def test_structured_kkt_blocks_of_midpoint_orbit_match_jax():
    """Free tf, a path row and 7 boundary rows through the structured KKT:
    prepare and the assembled blocks against the JAX operator."""
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    dj, dt = _pair("orbit_transfer", "midpoint", 6)
    assert (dt.q, dt.n_path, dt.n_boundary) == (1, 1, 7)
    rng = np.random.default_rng(3)
    z = dj.initial_guess(problem_j("orbit_transfer").init) + 0.01 * rng.standard_normal(dj.nz)
    lam, sc = rng.standard_normal(dj.nc), rng.uniform(0.5, 1.0, dj.nc)
    sigma, Drow = rng.uniform(0.1, 2.0, dj.nz), rng.uniform(0.0, 1.0, dj.nc)
    rz, rp = rng.standard_normal(dj.nz), rng.standard_normal(dj.nc)
    kj, kt = SJ(dj), ST(dt)
    data_j = jax.jit(kj.prepare)(jnp.asarray(z), jnp.asarray(lam), jnp.asarray(0.7), jnp.asarray(sc))
    data_t = kt.prepare(t(z), t(lam), 0.7, t(sc))
    for key in ("Hloc", "Jloc", "Hb", "Jfp", "Jbc"):
        np.testing.assert_allclose(n(data_t[key]), np.asarray(data_j[key]), rtol=0, atol=1e-10)
    blocks_j = kj._assemble(data_j, jnp.asarray(sigma), jnp.asarray(Drow), 1e-6, 1e-7,
                            jnp.asarray(rz), jnp.asarray(rp))
    blocks_t = kt._assemble(data_t, t(sigma), t(Drow), 1e-6, 1e-7, t(rz), t(rp))
    for a, b in zip(blocks_t, blocks_j):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-10)
    np.testing.assert_allclose(n(kt.row_norms(t(z))), np.asarray(kj.row_norms(jnp.asarray(z))), rtol=1e-12)


def test_default_scheme_front_door_analytic_oracle():
    """ct.solve with no scheme= runs midpoint (the default): objective 12,
    u = 6 - 12t, p(0) = [24, 12] at N=50."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    sol = ct.solve(get_problem("double_integrator_minenergy").ocp, grid_size=50, tol=1e-8,
                   device="cpu")
    assert sol.successful and sol.status == 0
    tg = sol.time_grid
    u = sol.control_values[:, 0]
    tm = 0.5 * (tg[:-1] + tg[1:])  # midpoint controls live at the step midpoints
    np.testing.assert_allclose(u[:-1], 6 - 12 * tm, atol=2e-2)
    np.testing.assert_allclose(sol.objective, 12.0, rtol=1e-2)
    P = sol.costate_values
    np.testing.assert_allclose(P[:-1, 0], 24.0, rtol=1e-2)
    np.testing.assert_allclose(P[0, 1], 12.0, rtol=5e-2)


@pytest.mark.parametrize(
    "strategy,kw",
    [("Collocation", {}), ("Collocation", dict(grid_size=9, scheme="euler_implicit")),
     ("DirectShooting", dict(grid_size=6, control_steps=3))],
)
def test_strategies_match_jax(strategy, kw):
    import ctdirect_tpu as cj
    import ctdirect_tpu_torch as ctt
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    dj = cj.discretize(problem_j("cartpole").ocp, getattr(cj, strategy)(**kw))
    dt = ctt.discretize(problem_t("cartpole").ocp, getattr(ctt, strategy)(**kw), device="cpu")
    assert dt.scheme.name == dj.scheme.name
    for attr in ("N", "cs", "nz", "nc"):
        assert getattr(dt, attr) == getattr(dj, attr), attr
    assert getattr(ctt, strategy).metadata().keys() == getattr(cj, strategy).metadata().keys()


def test_strategy_options_are_validated():
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.utils.options import OptionError

    with pytest.raises(OptionError, match="unknown option"):
        ct.Collocation(grid_sze=10)
    with pytest.raises(OptionError, match="invalid value"):
        ct.Collocation(scheme="rk4")
    assert ct.Collocation(mode="permissive", extra=1).opts["extra"] == 1
    # a Gauss-Legendre scheme discretizes as in the JAX package
    import ctdirect_tpu as cj

    gl = dict(scheme="gauss_legendre_2", grid_size=5)
    dt = ct.discretize(torch_docp().ocp, ct.Collocation(**gl), device="cpu")
    dj = cj.discretize(jax_docp().ocp, cj.Collocation(**gl))
    assert dt.scheme.name == dj.scheme.name == "gauss_legendre_2"
    for attr in ("N", "s", "cs", "bw", "cw", "nz", "nc"):
        assert getattr(dt, attr) == getattr(dj, attr), attr
