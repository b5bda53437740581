"""An exactly singular KKT system: the port's `DenseKKT.solve` gives what the
JAX package's gives (an LU with no check, non-finite entries where the
system has no solution), and a tiny NLP whose first dense system is singular
solves to the JAX `ipm_solve`'s status, iterations and objective (the
IPM's finiteness test rejects the singular step and regularizes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, singular_nlp, solve_both

# (W, J) of a system whose KKT matrix is singular: nz = 3, nc = 1
SYSTEMS = {
    # two dependent rows and columns (z0, z1 enter W and J only as z0 + 2 z1)
    "dependent_rows": (np.array([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0], [0.0, 0.0, 1.0]]),
                       np.array([[1.0, 2.0, 0.0]])),
    # a variable in neither W nor J: a zero row and column
    "zero_row": (np.diag([1.0, 0.0, 2.0]), np.array([[1.0, 0.0, 1.0]])),
}


@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_dense_solve_of_a_singular_system_matches_jax(case):
    from ctdirect_tpu.solver.kkt import DenseKKT as DJ
    from ctdirect_tpu_torch.solver.kkt import DenseKKT as DT

    W, J = SYSTEMS[case]
    rng = np.random.default_rng(0)
    rz, rp = rng.standard_normal(3), rng.standard_normal(1)
    zeros3, zeros1 = np.zeros(3), np.zeros(1)
    dz_j, dl_j = DJ(None, None, 3, 1).solve((jnp.asarray(W), jnp.asarray(J)), jnp.asarray(zeros3),
                                           jnp.asarray(zeros1), 0.0, 0.0, jnp.asarray(rz), jnp.asarray(rp))
    as_t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    dz_t, dl_t = DT(None, None, 3, 1).solve((as_t(W), as_t(J)), as_t(zeros3), as_t(zeros1),
                                           torch.tensor(0.0, dtype=torch.float64),
                                           torch.tensor(0.0, dtype=torch.float64), as_t(rz), as_t(rp))
    want = np.concatenate([np.asarray(dz_j), np.asarray(dl_j)])
    got = np.concatenate([n(dz_t), n(dl_t)])
    assert not np.isfinite(want).all()  # the JAX function's answer to a singular system
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_singular_nlp_solves_as_in_jax():
    """The first (unregularized) dense system is singular; both packages
    reject its step and regularize, converging to a=0, b=1."""
    rj, _, rt, _ = solve_both(singular_nlp, None, None, tol=1e-10)
    assert rt.status == int(rj.status) == 0
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(float(rt.objective), float(rj.objective), rtol=1e-10)
    np.testing.assert_allclose(float(rt.objective), 2.0, rtol=1e-8)
    np.testing.assert_allclose(n(rt.z), np.asarray(rj.z), rtol=0, atol=1e-10)
