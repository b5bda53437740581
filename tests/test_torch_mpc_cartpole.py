"""Cart-pole MPC (BASELINE config 3 at a small grid): the warm state a cold
start hands the tick, and the tick against the JAX tick from that state
(trapeze, N=12, B=3, float64, CPU).

The full IPM projects its final z onto the original box, so the cold-start z
sits EXACTLY on the active force bound; the tick's barrier terms mu/gap are
then infinite and the JAX package's tick (and the port's, before the repair)
returns NaN for every instance. `MPCController.cold_start` now moves the state
back inside by the IPM's own bound relaxation (`resolve.push_inside`)."""

import jax
import numpy as np
import pytest
import torch

from torch_helpers import n, t

N, B = 12, 3


@pytest.fixture(scope="module")
def controller():
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel.mpc import MPCController
    from ctdirect_tpu_torch.problems import get_problem

    prob = get_problem("cartpole")
    d = ct.transcribe(prob.ocp, grid_size=N, scheme="trapeze", device="cpu")
    ctrl = MPCController(d, x0_boundary_rows=[0, 1, 2, 3], resolve_iters=3, kkt_algorithm="cr",
                         device="cpu")
    opts = ct.IPMOptions(tol=1e-8, max_iter=200)
    x0 = 0.02 * np.random.default_rng(0).standard_normal((B, 4)) * np.array([1, 1, 0.5, 0.5])
    return dict(docp=d, ctrl=ctrl, opts=opts, warm=ctrl.cold_start(options=opts, init=prob.init),
                init=prob.init, x0=x0)


def test_cold_start_state_is_strictly_inside_the_box(controller):
    from ctdirect_tpu_torch.solver.interface import _get_solver

    d, warm = controller["docp"], controller["warm"]
    res, _ = _get_solver(d, controller["opts"])(
        d.initial_guess(controller["init"]), d._z_lb, d._z_ub, d._c_lb, d._c_ub
    )
    z_ipm, z = n(res.z), n(warm.z)
    assert np.sum(z_ipm == d._z_ub) + np.sum(z_ipm == d._z_lb) > 0  # the IPM's projected z
    assert np.all(z > d._z_lb) and np.all(z < d._z_ub)
    np.testing.assert_allclose(z, z_ipm, rtol=0, atol=1e-8 * 12.0)
    for ours, ipm in ((warm.lam, res.lam), (warm.wL, res.zL), (warm.wU, res.zU)):
        np.testing.assert_array_equal(n(ours), n(ipm))  # only the primal point moves


def test_tick_from_cold_start_is_finite_and_matches_jax(controller):
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController as MPCJ
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu.solver.resolve import WarmState as WarmJ
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    states = broadcast_state(controller["warm"], B)
    st, u0, kkt, viol = controller["ctrl"](states, t(controller["x0"]))
    assert torch.isfinite(u0).all() and torch.isfinite(kkt).all()
    assert u0.abs().max().item() <= 12.0 * (1 + 1e-6)

    ctrl_j = MPCJ(transcribe(problem_j("cartpole").ocp, grid_size=N, scheme="trapeze"),
                  x0_boundary_rows=[0, 1, 2, 3], resolve_iters=3, kkt_algorithm="cr")
    sj, uj, kj, vj = ctrl_j(WarmJ(*(n(a) for a in states)), controller["x0"])
    for a, b in zip(st, jax.device_get(sj)):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(n(u0), np.asarray(uj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(n(kkt), np.asarray(kj), rtol=1e-6, atol=1e-12)
