"""BASELINE config 2 at test size: Goddard (free final time, singular arc),
Gauss-Legendre 2-stage with constant control, adaptive mu, tol 1e-8, the
cyclic-reduction KKT solve, in both packages (CPU), once with the f64 block
solve and once with the f32 block solve + 2 refinement sweeps + Ruiz.

The standard is tests/test_accuracy.py's: the same status, the objective to
1e-7 relative and the controls to 1e-4 in L-inf. Iteration counts on the
goddard family depend on rounding (ROADMAP.md, queue 3), so they are not
compared."""

import numpy as np
import pytest

N = 10
SCHEME = "gauss_legendre_2_constant_control"
CONFIGS = {"f64": None, "f32_refine2_ruiz": "f32"}

_cache = {}


def _solve(package, config):
    """One solve per (package, config), shared by the tests of this file."""
    key = (package, config)
    if key not in _cache:
        if package == "jax":
            import ctdirect_tpu as ct
            from ctdirect_tpu.problems import get_problem

            kw = {}
        else:
            import ctdirect_tpu_torch as ct
            from ctdirect_tpu_torch.problems import get_problem

            kw = dict(device="cpu")
        p = get_problem("goddard")
        opts = ct.IPMOptions(tol=1e-8, mu_strategy="adaptive", kkt_mode="cr",
                             kkt_solve_dtype=CONFIGS[config])
        _cache[key] = ct.solve(p.ocp, grid_size=N, scheme=SCHEME, init=p.init, options=opts, **kw)
    return _cache[key]


def _assert_close(a, b):
    assert a.successful and b.successful, (a.message, b.message)
    assert a.status == b.status
    assert abs(a.objective - b.objective) <= 1e-7 * abs(b.objective)
    assert np.max(np.abs(a.control_values - b.control_values)) <= 1e-4
    np.testing.assert_allclose(a.variable, b.variable, rtol=1e-6)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_goddard_gl2_matches_jax(config):
    port, ref = _solve("torch", config), _solve("jax", config)
    assert port.control_values.shape == ref.control_values.shape
    _assert_close(port, ref)
    np.testing.assert_allclose(port.objective, 1.01257, rtol=1e-2)  # the fixture's reference


def test_goddard_gl2_f32_refined_matches_f64():
    """The mixed-precision solve lands on the f64 solve's optimum (the check
    the card's phase 10 makes at N=200)."""
    _assert_close(_solve("torch", "f32_refine2_ruiz"), _solve("torch", "f64"))
