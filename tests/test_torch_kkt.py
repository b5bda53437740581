"""Structured KKT parity: the PyTorch StructuredKKT (prepare, assembly, the
sequential scan solve) against the JAX StructuredKKT, and the structured
direction against the port's dense oracle (double integrator, trapeze,
float64). Same math, different summation order: 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import jax_docp, n, t, torch_docp

TOL = 1e-10


def _inputs(d, seed=42):
    rng = np.random.default_rng(seed)
    return dict(
        z=d.initial_guess() + 0.01 * rng.standard_normal(d.nz),
        lam=rng.standard_normal(d.nc),
        sf=0.7,
        sc=rng.uniform(0.5, 1.0, d.nc),
        sigma=rng.uniform(0.1, 2.0, d.nz),
        Drow=rng.uniform(0.0, 1.0, d.nc),
        rz=rng.standard_normal(d.nz),
        rp=rng.standard_normal(d.nc),
    )


@pytest.fixture(scope="module")
def pair():
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    dj, dt = jax_docp(grid_size=7), torch_docp(grid_size=7)
    kj, kt = SJ(dj), ST(dt)
    x = _inputs(dj)
    data_j = kj.prepare(jnp.asarray(x["z"]), jnp.asarray(x["lam"]), jnp.asarray(x["sf"]), jnp.asarray(x["sc"]))
    data_t = kt.prepare(t(x["z"]), t(x["lam"]), x["sf"], t(x["sc"]))
    args = ("sigma", "Drow")
    blocks_j = kj._assemble(data_j, *(jnp.asarray(x[k]) for k in args), 1e-6, 1e-7,
                            jnp.asarray(x["rz"]), jnp.asarray(x["rp"]))
    blocks_t = kt._assemble(data_t, *(t(x[k]) for k in args), 1e-6, 1e-7, t(x["rz"]), t(x["rp"]))
    return dict(dj=dj, dt=dt, kj=kj, kt=kt, x=x, data_j=data_j, data_t=data_t,
                blocks_j=blocks_j, blocks_t=blocks_t)


@pytest.mark.parametrize("key", ["Hloc", "Jloc", "Hb", "Jfp", "Jbc"])
def test_prepare_matches_jax(pair, key):
    np.testing.assert_allclose(n(pair["data_t"][key]), np.asarray(pair["data_j"][key]), rtol=0, atol=TOL)


@pytest.mark.parametrize("i,name", list(enumerate(["A", "B", "E", "F", "r", "rb"])))
def test_assemble_matches_jax(pair, i, name):
    np.testing.assert_allclose(n(pair["blocks_t"][i]), np.asarray(pair["blocks_j"][i]), rtol=0, atol=TOL)


def test_scan_solve_matches_jax(pair):
    from ctdirect_tpu.solver.structured_kkt import _scan_solve as scan_j
    from ctdirect_tpu_torch.solver.structured_kkt import _scan_solve as scan_t

    Xj, xbj = scan_j(*pair["blocks_j"])
    Xt, xbt = scan_t(*pair["blocks_t"])
    np.testing.assert_allclose(n(Xt), np.asarray(Xj), rtol=0, atol=TOL)
    np.testing.assert_allclose(n(xbt), np.asarray(xbj), rtol=0, atol=TOL)


def test_row_norms_and_lsq_lambda_match_jax(pair):
    x, kj, kt = pair["x"], pair["kj"], pair["kt"]
    np.testing.assert_allclose(n(kt.row_norms(t(x["z"]))), np.asarray(kj.row_norms(jnp.asarray(x["z"]))),
                               rtol=1e-12)
    lj = kj.lsq_lambda(jnp.asarray(x["z"]), jnp.asarray(x["rz"]), 0.7, jnp.asarray(x["sc"]))
    lt = kt.lsq_lambda(t(x["z"]), t(x["rz"]), 0.7, t(x["sc"]))
    np.testing.assert_allclose(n(lt), np.asarray(lj), rtol=0, atol=TOL * (1 + np.abs(lj).max()))


@pytest.mark.parametrize("algorithm", ["scan", "cr"])
def test_direction_matches_dense(algorithm):
    """Structured direction == the port's dense oracle (after
    tests/test_structured.py::test_direction_matches_dense)."""
    from ctdirect_tpu_torch.solver.kkt import DenseKKT
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    d = torch_docp(grid_size=7)
    x = _inputs(d)
    dense = DenseKKT(d.nlp_objective, d.constraints, d.nz, d.nc)
    struct = StructuredKKT(d, algorithm=algorithm)
    z, lam, sc = t(x["z"]), t(x["lam"]), t(x["sc"])
    sf = torch.tensor(0.7, dtype=torch.float64)
    np.testing.assert_allclose(n(struct.row_norms(z)), n(dense.row_norms(z)), rtol=1e-12)
    rest = (t(x["sigma"]), t(x["Drow"]), 1e-6, 1e-7, t(x["rz"]), t(x["rp"]))
    dz_d, dl_d = dense.solve(dense.prepare(z, lam, sf, sc), *rest)
    dz_s, dl_s = struct.solve(struct.prepare(z, lam, sf, sc), *rest)
    scale = 1 + np.abs(n(dz_d)).max()
    np.testing.assert_allclose(n(dz_s), n(dz_d), atol=1e-9 * scale)
    scale_l = 1 + np.abs(n(dl_d)).max()
    np.testing.assert_allclose(n(dl_s), n(dl_d), atol=1e-9 * scale_l)


def test_gj_kernels():
    from ctdirect_tpu_torch.solver.kkt import gj_inverse, gj_solve

    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12))
    A[0, 0] = 0.0  # force a pivot swap
    B = rng.standard_normal((12, 3))
    X = n(gj_solve(t(A), t(B)))
    np.testing.assert_allclose(A @ X, B, atol=1e-10)
    Ainv = n(gj_inverse(t(A)))
    np.testing.assert_allclose(A @ Ainv, np.eye(12), atol=1e-10)


@pytest.mark.parametrize("n_", [9, 14, 18, 21, 28, 49])
@pytest.mark.parametrize("seed", range(3))
def test_gj_eliminate_matches_a_plain_loop_bit_for_bit(seed, n_):
    """The gather/select elimination picks the pivots a plain loop picks,
    ties included (entries drawn from five values), and does the same
    arithmetic: equal bit for bit, unbatched and under vmap, at the widths
    of the fixtures' structured solves (space_shuttle's blocks 14 and
    border 18, quadrotor's 21 and 28) and at 49."""
    from ctdirect_tpu_torch.solver.kkt import _gj_eliminate
    from torch_helpers import gj_loop

    rng = np.random.default_rng(seed)
    k = 3
    mats = []
    while len(mats) < 4:
        M = rng.choice([-0.3, -0.1, 0.1, 0.3, 0.7], size=(n_, n_ + k))
        if np.linalg.cond(M[:, :n_]) < 1e6:
            mats.append(M)
    want = np.stack([gj_loop(M, n_) for M in mats])
    got = np.stack([n(_gj_eliminate(t(M), n_)) for M in mats])
    np.testing.assert_array_equal(got, want)
    batched = torch.func.vmap(lambda M: _gj_eliminate(M, n_))(t(np.stack(mats)))
    np.testing.assert_array_equal(n(batched), want)
