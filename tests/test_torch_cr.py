"""Batched block cyclic reduction: the plain PyTorch `cr_solve_lanes` (the
CUDA kernel's plain version) against the JAX lane-minor engine and against
the JAX Pallas kernel in interpret mode. The port-only checks (dense-residual
oracle, dispatch, wrapper, kernel on the card) are in test_torch_cr_kernel.py,
which imports no JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, random_chain_lanes, t

from ctdirect_tpu_torch.solver import lanes

# f64: same recurrences, different summation order -> rounding level;
# f32: the solve's own roundoff (cond * eps_f32), as tests/test_pallas.py
TOL = {np.float64: 1e-12, np.float32: 2e-4}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("P,bs,wb,B", [(8, 3, 2, 16), (16, 5, 7, 8), (1, 4, 3, 5)])
def test_plain_cr_matches_jax_lanes(P, bs, wb, B, dtype):
    from ctdirect_tpu.solver import lanes as lanes_j

    chain = random_chain_lanes(P, bs, wb, B, seed=P + bs, dtype=dtype)
    Xj, xbj = jax.jit(lanes_j.cr_solve_lanes)(*(jnp.asarray(x) for x in chain))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    Xt, xbt = lanes.cr_solve_lanes(*(t(x, tdt) for x in chain))
    tol = TOL[dtype]
    np.testing.assert_allclose(n(Xt), np.asarray(Xj), rtol=tol, atol=tol)
    np.testing.assert_allclose(n(xbt), np.asarray(xbj), rtol=tol, atol=tol)


def test_plain_cr_matches_pallas_interpret():
    """Against the TPU kernel itself, run as tests/test_pallas.py runs it."""
    from ctdirect_tpu.solver.pallas_cr import cr_solve_lanes_pallas

    chain = random_chain_lanes(8, 3, 2, 128, dtype=np.float32)
    Xp, xbp = cr_solve_lanes_pallas(*(jnp.asarray(x) for x in chain), interpret=True)
    Xt, xbt = lanes.cr_solve_lanes(*(t(x, torch.float32) for x in chain))
    np.testing.assert_allclose(n(Xt), np.asarray(Xp), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(n(xbt), np.asarray(xbp), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("N,bs,wb", [(1, 4, 3), (13, 5, 7), (16, 19, 8)])
def test_unbatched_cr_matches_jax_chain_lanes(N, bs, wb):
    """The port's unbatched `lanes.cr_solve` (the batched CR at B=1, which the
    kernel's B=1 launches serve on the card) against the JAX package's
    single-instance chain-in-lanes CR, the unbatched `cr` path there."""
    from ctdirect_tpu.solver.structured_kkt import _cr_solve_chain_lanes

    A, Bp, E, F, r, rb = (x[..., 0] for x in random_chain_lanes(N, bs, wb, 1, seed=N + bs))
    args = (A, Bp[: N - 1], E, F, r, rb)
    Xj, xbj = jax.jit(_cr_solve_chain_lanes)(*(jnp.asarray(x) for x in args))
    Xt, xbt = lanes.cr_solve(*(t(x) for x in args))
    assert Xt.shape == (N, bs) and xbt.shape == (wb,)
    np.testing.assert_allclose(n(Xt), np.asarray(Xj), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(n(xbt), np.asarray(xbj), rtol=1e-10, atol=1e-10)
