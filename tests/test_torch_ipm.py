"""Full interior-point solve: the PyTorch IPM against the JAX IPM on the same
cold start (double integrator, trapeze, N=12, float64), and the front door
`ct.solve` against the analytic oracle of tests/test_solve.py."""

import numpy as np
import pytest

from torch_helpers import DI, jax_docp, n, torch_docp

OPTS = dict(tol=1e-8, max_iter=60)


@pytest.fixture(scope="module")
def results():
    from ctdirect_tpu.solver.interface import _get_solver as solver_j
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu_torch.solver.interface import _get_solver as solver_t
    from ctdirect_tpu_torch.solver.ipm import IPMOptions as OptsT

    out = {}
    for kind, docp, get_solver, opts in (
        ("jax", jax_docp(), solver_j, OptsJ(**OPTS)),
        ("torch", torch_docp(), solver_t, OptsT(**OPTS)),
    ):
        run = get_solver(docp, opts)
        res, _ = run(docp.initial_guess(), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        out[kind] = res
    return out


def test_cold_start_status_and_iterations_match_jax(results):
    rj, rt = results["jax"], results["torch"]
    assert int(rt.status) == int(rj.status) == 0
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1


def test_cold_start_objective_and_iterate_match_jax(results):
    rj, rt = results["jax"], results["torch"]
    np.testing.assert_allclose(float(rt.objective), float(rj.objective), rtol=1e-8)
    np.testing.assert_allclose(n(rt.z), np.asarray(rj.z), rtol=0, atol=1e-7)
    scale = 1 + np.abs(np.asarray(rj.lam)).max()
    np.testing.assert_allclose(n(rt.lam), np.asarray(rj.lam), rtol=0, atol=1e-7 * scale)


def test_dense_mode_matches_jax():
    """kkt_mode="dense" (the oracle path) lands on the same solution."""
    from ctdirect_tpu.solver.interface import solve_docp as solve_j
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu_torch.solver.interface import solve_docp as solve_t
    from ctdirect_tpu_torch.solver.ipm import IPMOptions as OptsT

    sj = solve_j(jax_docp(grid_size=6), options=OptsJ(kkt_mode="dense", **OPTS))
    st = solve_t(torch_docp(grid_size=6), options=OptsT(kkt_mode="dense", **OPTS))
    assert st.status == sj.status == 0
    np.testing.assert_allclose(st.objective, sj.objective, rtol=1e-8)
    np.testing.assert_allclose(st.state_values, sj.state_values, atol=1e-7)


def test_front_door_analytic_oracle():
    """README quick start through ct.solve: objective 12, p(0)[0] = 24 (after
    tests/test_solve.py::test_double_integrator_analytic)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    sol = ct.solve(get_problem(DI).ocp, grid_size=50, scheme="trapeze", tol=1e-8, device="cpu")
    assert sol.successful
    t = sol.time_grid
    u = sol.control_values[:, 0]
    assert np.max(np.abs(u[2:-2] - (6 - 12 * t[2:-2]))) < 2e-2
    np.testing.assert_allclose(sol.objective, 12.0, rtol=1e-2)
    P = sol.costate_values
    np.testing.assert_allclose(P[0, 0], 24.0, rtol=1e-2)
    np.testing.assert_allclose(P[:-1, 0], 24.0, rtol=1e-2)


def test_max_iter_zero_round_trips_the_initial_guess():
    """max_iter=0: the solution is the (0.1-filled) initial guess, status 0."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    sol = ct.solve(get_problem(DI).ocp, grid_size=8, scheme="trapeze", max_iter=0, device="cpu")
    assert sol.status == 0 and sol.iterations == 0
    np.testing.assert_allclose(sol.state_values, 0.1)


def test_batched_adaptive_mu_and_max_iter_zero():
    """The batched IPM under the adaptive barrier rule follows each instance's
    unbatched solve; max_iter=0 round-trips every instance's initial guess."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.interface import _get_solver

    from torch_helpers import batch_inputs

    p = get_problem("cartpole")
    d = ct.transcribe(p.ocp, grid_size=8, scheme="trapeze", device="cpu")
    z0, cl, cu, zl, zu = batch_inputs(d, p.init, seed=0, box_scale=[1.0, 1.25, 0.95])
    opts = ct.IPMOptions(tol=1e-8, max_iter=60, mu_strategy="adaptive")
    res = BatchSolver(d, opts, device="cpu")(z0, cl, cu, zl, zu)
    run = _get_solver(d, opts)
    for b in range(len(z0)):
        r, _ = run(z0[b], zl[b], zu[b], cl[b], cu[b])
        assert int(r.status) == int(res.status[b]) == 0
        assert int(r.iterations) == int(res.iterations[b])
        np.testing.assert_allclose(n(res.z[b]), n(r.z), rtol=0, atol=1e-10)
    res0 = BatchSolver(d, opts.replace(max_iter=0), device="cpu")(z0, cl, cu, zl, zu)
    assert n(res0.status).tolist() == [0] * len(z0) and n(res0.iterations).tolist() == [0] * len(z0)
    np.testing.assert_allclose(n(res0.z), np.clip(z0, zl, zu), rtol=0, atol=1e-6)
