"""Transcription parity: the PyTorch DOCP against the JAX DOCP (double
integrator, trapeze, N=12, float64). Both evaluate the same residual program,
so agreement is at rounding level (1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import jax_docp, n, t, torch_docp

TOL = 1e-12


@pytest.fixture(scope="module")
def docps():
    return jax_docp(), torch_docp()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_callbacks_match_jax(docps, seed):
    dj, dt = docps
    z = np.random.default_rng(seed).standard_normal(dj.nz)
    np.testing.assert_allclose(n(dt.constraints(t(z))), np.asarray(dj.constraints(jnp.asarray(z))), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(dt.objective(t(z))), float(dj.objective(jnp.asarray(z))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(dt.nlp_objective(t(z))), float(dj.nlp_objective(jnp.asarray(z))), rtol=TOL, atol=TOL
    )


def test_layout_bounds_and_initial_guess_match_jax(docps):
    dj, dt = docps
    for attr in ("N", "n", "m", "q", "bw", "cw", "nz", "nc", "tail_w"):
        assert getattr(dt, attr) == getattr(dj, attr), attr
    for a, b in zip(dt.z_bounds + dt.c_bounds, dj.z_bounds + dj.c_bounds):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(dt.initial_guess(), dj.initial_guess(), rtol=0, atol=TOL)
    for fn in ("boundary_row_indices", "defect_row_indices", "state_col_indices",
               "control_output_col_indices"):
        np.testing.assert_array_equal(getattr(dt, fn)(), getattr(dj, fn)())


def test_pack_unpack_postprocess_match_jax(docps):
    dj, dt = docps
    z = np.random.default_rng(5).standard_normal(dj.nz)
    Vj, Vt = dj.unpack(jnp.asarray(z)), dt.unpack(t(z))
    np.testing.assert_array_equal(n(Vt.X), np.asarray(Vj.X))
    np.testing.assert_array_equal(n(Vt.U), np.asarray(Vj.U))
    np.testing.assert_array_equal(n(dt.pack(Vt.X, Vt.U, Vt.K, Vt.v)), z)
    for a, b in zip(dt.postprocess(t(z)), dj.postprocess(jnp.asarray(z))):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=TOL)


def test_unported_scheme_raises():
    from ctdirect_tpu_torch import PreOCP, transcribe

    pre = PreOCP("di")
    pre.state(2).control(1).time(t0=0.0, tf=1.0)
    pre.dynamics(lambda t_, x, u, v: torch.stack([x[1], u[0]]))
    pre.objective(lagrange=lambda t_, x, u, v: u[0] ** 2)
    ocp = pre.build()
    # every scheme name of the JAX package is ported; an unknown one raises
    with pytest.raises(ValueError, match="unknown scheme"):
        transcribe(ocp, grid_size=4, scheme="gauss_legendre_4", device="cpu")
    with pytest.raises(TypeError):
        transcribe(ocp, grid_size=4, scheme="trapeze")  # device is required
