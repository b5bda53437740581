"""`ipm_solve(..., return_history=True)` against the JAX package's (its
masked fixed-length scan, jitted) on the CPU: the iteration count and the
filter's next slot exactly, mu, the last regularization and the scaled
objective to 1e-10 relative, the KKT error to 1e-10 relative above an
absolute floor of 1e-13 (it is a max of residuals whose terms are O(1), so
two correct solves differ there by the rounding of those terms, which is
far above 1e-10 relative once the error is small). The rows after
convergence repeat the last iteration's values; max_iter=0 gives no
history; asking for it leaves the solve as it was."""

import numpy as np
import pytest
import torch

from torch_helpers import jax_docp, n, singular_nlp, solve_both, torch_docp

MAX_ITER = 40  # the cart-pole converges in 23 and the singular NLP in 2: later rows repeat


def _cartpole(xp):
    from ctdirect_tpu.problems import get_problem

    docp = jax_docp("cartpole", 12) if xp.__name__.startswith("jax") else torch_docp("cartpole", 12)
    bounds = (docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    return docp.nlp_objective, docp.constraints, bounds, docp.initial_guess(get_problem("cartpole").init)


def _kkts(case):
    """(JAX operator, port operator): the structured scan solve for the
    cart-pole, the dense default (None) for the singular NLP, whose first
    regularized trial makes delta_w nonzero."""
    if case == "singular":
        return None, None
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    return SJ(jax_docp("cartpole", 12)), ST(torch_docp("cartpole", 12))


@pytest.mark.parametrize("case", ["cartpole", "singular"])
def test_history_matches_jax(case):
    problem = _cartpole if case == "cartpole" else singular_nlp
    rj, hj, rt, ht = solve_both(problem, *_kkts(case), tol=1e-8, max_iter=MAX_ITER)
    assert rt.status == int(rj.status) == 0 and rt.iterations == int(rj.iterations) < MAX_ITER
    assert len(ht) == len(hj) == 6
    it, mu, kkt_err, filt_n, delta_w, f = (n(h) for h in ht)
    for got in (it, mu, kkt_err, filt_n, delta_w, f):
        assert got.shape == (MAX_ITER,)
    np.testing.assert_array_equal(it, np.asarray(hj[0]))
    np.testing.assert_array_equal(filt_n, np.asarray(hj[3]))
    for got, want in ((mu, hj[1]), (delta_w, hj[4]), (f, hj[5])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-10, atol=0)
    np.testing.assert_allclose(kkt_err, np.asarray(hj[2]), rtol=1e-10, atol=1e-13)
    k = rt.iterations
    np.testing.assert_array_equal(it, np.minimum(np.arange(1, MAX_ITER + 1), k))
    for h in (mu, kkt_err, filt_n, delta_w, f):  # the rows after convergence repeat the last
        assert (h[k - 1:] == h[k - 1]).all()
    assert float(kkt_err[k - 1]) == float(rt.kkt_error)
    if case == "singular":
        assert delta_w[0] > 0  # the singular first system was regularized


def test_history_is_none_at_max_iter_zero_and_leaves_the_solve_unchanged():
    from ctdirect_tpu_torch.solver.ipm import IPMOptions, ipm_solve, make_spec

    f, c, bounds, z0 = singular_nlp(torch)
    spec = make_spec(*bounds)
    res, hist = ipm_solve(f, c, spec, z0, *bounds, options=IPMOptions(max_iter=0), return_history=True,
                          device="cpu")
    assert hist is None and res.status == 0 and res.iterations == 0
    plain = ipm_solve(f, c, spec, z0, *bounds, device="cpu")
    recorded, hist = ipm_solve(f, c, spec, z0, *bounds, return_history=True, device="cpu")
    assert hist[0].dtype == torch.long and hist[1].dtype == torch.float64
    for a, b in zip(plain, recorded):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
