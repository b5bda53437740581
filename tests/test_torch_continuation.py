"""Continuation and grid continuation, the port against the JAX package on
the CPU in float64 (after tests/test_continuation.py): the same sequence of
warm-started solves gives the same statuses and iteration counts, and
objectives equal to 1e-8 relative (both solve to tol 1e-8 from the same
warm start)."""

import numpy as np
import torch


def _di_horizon(jax_side):
    """Min-energy double integrator with horizon T (objective 12 / T^3)."""
    if jax_side:
        import jax.numpy as jnp

        from ctdirect_tpu.model.ocp import PreOCP

        stack = jnp.array
    else:
        from ctdirect_tpu_torch.model.ocp import PreOCP

        stack = torch.stack

    def make(T):
        pre = PreOCP(f"di_T{T}")
        pre.state(2).control(1)
        pre.time(t0=0.0, tf=float(T))
        pre.dynamics(lambda t_, x, u, v: stack([x[1], u[0]]))
        pre.objective(lagrange=lambda t_, x, u, v: u[0] ** 2)
        pre.initial_state([0.0, 0.0]).final_state([1.0, 0.0])
        return pre.build()

    return make


def _assert_same(sols_t, sols_j):
    assert len(sols_t) == len(sols_j)
    for st, sj in zip(sols_t, sols_j):
        assert st.successful and sj.successful
        assert (st.status, st.iterations) == (sj.status, sj.iterations)
        np.testing.assert_allclose(st.objective, sj.objective, rtol=1e-8)
        np.testing.assert_allclose(st.state_values, sj.state_values, rtol=0, atol=1e-7)


def test_continuation_matches_jax():
    from ctdirect_tpu.solver.continuation import continuation as cont_j
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu_torch.solver import IPMOptions as OptsT
    from ctdirect_tpu_torch.solver import continuation as cont_t

    kw = dict(grid_size=20, scheme="trapeze")
    sj = cont_j(_di_horizon(True), [1, 2], options=OptsJ(tol=1e-8), **kw)
    st = cont_t(_di_horizon(False), [1, 2], options=OptsT(tol=1e-8), device="cpu", **kw)
    _assert_same(st, sj)
    np.testing.assert_allclose([s.objective for s in st], [12.0, 1.5], rtol=2e-2)


def test_grid_continuation_matches_jax():
    """Free final time (the variable is warm-started too), coarse to fine."""
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu.solver.continuation import grid_continuation as grid_j
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu_torch.problems import get_problem as problem_t
    from ctdirect_tpu_torch.solver import IPMOptions as OptsT
    from ctdirect_tpu_torch.solver import grid_continuation as grid_t

    name, grids = "double_integrator_mintf", (10, 20)
    sj = grid_j(problem_j(name).ocp, grids, options=OptsJ(tol=1e-8))
    st = grid_t(problem_t(name).ocp, grids, options=OptsT(tol=1e-8), device="cpu")
    _assert_same(st, sj)
    assert [len(s.time_grid) for s in st] == [11, 21]
    np.testing.assert_allclose(st[-1].objective, 2.0, rtol=1e-2)
