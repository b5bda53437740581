"""Gauss-Legendre (implicit Runge-Kutta) schemes: the port's `GenericIRK`
against the JAX package's on the same numpy-seeded inputs (float64, CPU).

- the scheme forms (defects D and stage residuals S, quadrature,
  node_controls, control_times, local_residual, local_cost) for all five GL
  names on goddard (Mayer, free tf) and fuller (Lagrange cost): same
  formulas, 1e-12;
- the GL DOCPs (layout with stage variables K, bounds, initial guess, NLP
  callbacks): 1e-12;
- the exact-feasible residual gate of tests/test_transcription.py;
- the structured KKT's prepare and assembled blocks for goddard
  GL2-constant-control against JAX (1e-10: another summation order), and its
  direction against the port's dense oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import box_sample, n, t

TOL = 1e-12

GL = [
    "gauss_legendre_1",
    "gauss_legendre_2",
    "gauss_legendre_3",
    "gauss_legendre_2_constant_control",
    "gauss_legendre_3_constant_control",
]


def test_get_scheme_takes_every_jax_name():
    """The port's SCHEMES is the JAX tuple, and every name builds the same
    scheme (name, order, stages, controls per step)."""
    from ctdirect_tpu.transcription.schemes import SCHEMES as SJ
    from ctdirect_tpu.transcription.schemes import get_scheme as get_j
    from ctdirect_tpu_torch.transcription.schemes import SCHEMES as ST
    from ctdirect_tpu_torch.transcription.schemes import get_scheme as get_t

    assert ST == SJ and len(ST) == 12
    for name in ST:
        a, b = get_t(name), get_j(name)
        assert (a.name, a.order, a.stages, a.cs, a.u_at_nodes) == (b.name, b.order, b.stages, b.cs, b.u_at_nodes)
    with pytest.raises(ValueError, match="unknown scheme"):
        get_t("gauss_legendre_4")


def _pair(name, scheme, grid_size):
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    dj = transcribe_j(problem_j(name).ocp, grid_size=grid_size, scheme=scheme)
    dt = transcribe_t(problem_t(name).ocp, grid_size=grid_size, scheme=scheme, device="cpu")
    return dj, dt


def _scheme_inputs(d, seed):
    """Random (X, U, K, t, h, v) of a DOCP's shapes, states and controls
    inside the fixture's boxes."""
    rng = np.random.default_rng(seed)
    ocp = d.ocp
    X = box_sample(rng, ocp.x_lb, ocp.x_ub, (d.N + 1, d.n))
    U = box_sample(rng, ocp.u_lb, ocp.u_ub, (d.Nu, d.cs, d.m))
    K = 0.1 * rng.standard_normal((d.N, d.s, d.n))
    tg = np.sort(rng.uniform(0.0, 2.0, d.N + 1))
    v = box_sample(rng, ocp.v_lb, ocp.v_ub)
    return X, U, K, tg, np.diff(tg), v


@pytest.mark.parametrize("scheme", GL)
@pytest.mark.parametrize("name", ["goddard", "fuller"])
def test_gl_scheme_forms_match_jax(name, scheme):
    dj, dt = _pair(name, scheme, 6)
    sj, st = dj.scheme, dt.scheme
    assert (st.name, st.order, st.stages, st.cs, st.stagewise) == (
        sj.name, sj.order, sj.stages, sj.cs, sj.stagewise)
    for attr in ("A", "b", "c"):
        np.testing.assert_array_equal(getattr(st, attr), getattr(sj, attr))
    X, U, K, tg, h, v = _scheme_inputs(dj, seed=len(scheme))
    jx = [jnp.asarray(a) for a in (X, U, K, tg, h, v)]
    tx = [t(a) for a in (X, U, K, tg, h, v)]
    (Dj, Sj), (Dt, St) = sj.defects(dj.fns, *jx), st.defects(dt.fns, *tx)
    np.testing.assert_allclose(n(Dt), np.asarray(Dj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(n(St), np.asarray(Sj), rtol=TOL, atol=TOL)
    if dj.fns.lagrange is not None:
        np.testing.assert_allclose(float(st.quadrature(dt.fns, *tx)), float(sj.quadrature(dj.fns, *jx)),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(n(st.node_controls(tx[1])), np.asarray(sj.node_controls(jx[1])),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(st.control_times(tg, h), sj.control_times(tg, h))
    for i in (0, 4):
        args = (tg[i], tg[i + 1], X[i], U[i], K[i], X[i + 1])
        args_j = [jnp.asarray(a) for a in args] + [None, jx[5]]
        args_t = [t(a) for a in args] + [None, tx[5]]
        np.testing.assert_allclose(n(st.local_residual(dt.fns, *args_t)),
                                   np.asarray(sj.local_residual(dj.fns, *args_j)), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(n(st.local_node_control(t(U[i]))),
                                   np.asarray(sj.local_node_control(jnp.asarray(U[i]))), rtol=TOL, atol=TOL)
        if dj.fns.lagrange is not None:
            np.testing.assert_allclose(float(st.local_cost(dt.fns, *args_t)),
                                       float(sj.local_cost(dj.fns, *args_j)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scheme", GL)
def test_gl_docp_matches_jax(scheme):
    """Goddard transcribed with each GL scheme at N=6: layout (stage variables
    K in every step block), bounds, initial guess, index maps and the NLP
    callbacks at random points."""
    from ctdirect_tpu.problems import get_problem as problem_j

    dj, dt = _pair("goddard", scheme, 6)
    init = problem_j("goddard").init
    for attr in ("N", "n", "m", "q", "s", "cs", "Nu", "bw", "cw", "nz", "nc", "tail_w"):
        assert getattr(dt, attr) == getattr(dj, attr), attr
    for a, b in zip(dt.z_bounds + dt.c_bounds, dj.z_bounds + dj.c_bounds):
        np.testing.assert_array_equal(a, b)
    z0 = dj.initial_guess(init)
    np.testing.assert_allclose(dt.initial_guess(init), z0, rtol=0, atol=TOL)
    for fn in ("defect_row_indices", "path_row_indices", "state_col_indices",
               "control_output_col_indices", "control_col_indices"):
        np.testing.assert_array_equal(getattr(dt, fn)(), getattr(dj, fn)())
    for seed in (0, 1):
        z = z0 + 0.01 * np.random.default_rng(seed).standard_normal(dj.nz)
        np.testing.assert_allclose(n(dt.constraints(t(z))), np.asarray(dj.constraints(jnp.asarray(z))),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(dt.nlp_objective(t(z))), float(dj.nlp_objective(jnp.asarray(z))),
                                   rtol=TOL, atol=TOL)
        for a, b in zip(dt.postprocess(t(z)), dj.postprocess(jnp.asarray(z))):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=TOL, atol=TOL)


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


def _exact_z(d):
    """The analytic trajectory x = t², u = 2t, stage variables K = u(t_ij)."""
    tg = n(d.time_grid(t(np.zeros(0))))
    h = np.diff(tg)
    if d.scheme.name == "gauss_legendre_1":  # the step control lives at the midpoint time
        ut = (0.5 * (tg[:-1] + tg[1:]))[:, None]
    else:
        ut = d.scheme.control_times(tg, h)
    tij = tg[:-1, None] + d.scheme.c[None, :] * h[:, None]
    return d.pack(t((tg**2)[:, None]), t((2 * ut)[:, :, None]), t((2 * tij)[:, :, None]), t(np.zeros(0)))


@pytest.mark.parametrize("scheme", ["gauss_legendre_1", "gauss_legendre_2", "gauss_legendre_3"])
def test_exact_feasible_residual_gl(scheme):
    """x = t², u = 2t is exactly feasible: the GL schemes with a control per
    stage give zero defects and stage residuals (the port of
    tests/test_transcription.py::test_exact_feasible_residual for its GL
    cases), and Gauss quadrature of u² = 4t² is exact: 4/3."""
    from ctdirect_tpu_torch import transcribe

    d = transcribe(_scalar_problem(), grid_size=7, scheme=scheme, device="cpu")
    z = _exact_z(d)
    c = n(d.constraints(z))
    cl, cu = d.c_bounds
    eq = (cl == cu) & (cl == 0)
    np.testing.assert_allclose(c[eq], 0.0, atol=1e-12)
    np.testing.assert_allclose(c[d.boundary_row_indices()], [0.0, 1.0], atol=1e-12)
    if scheme != "gauss_legendre_1":
        assert abs(float(d.objective(z)) - 4.0 / 3.0) < 1e-12


def _kkt_inputs(d, init, seed=7):
    rng = np.random.default_rng(seed)
    return dict(
        z=d.initial_guess(init) + 0.01 * rng.standard_normal(d.nz),
        lam=rng.standard_normal(d.nc),
        sc=rng.uniform(0.5, 1.0, d.nc),
        sigma=rng.uniform(0.1, 2.0, d.nz),
        Drow=rng.uniform(0.0, 1.0, d.nc),
        rz=rng.standard_normal(d.nz),
        rp=rng.standard_normal(d.nc),
    )


def test_structured_kkt_blocks_of_goddard_gl2_match_jax():
    """Goddard GL2-constant-control at N=5 (bs + wb = 19 + 8): prepare's
    per-step Hessians/Jacobians (stage variables K inside each step block)
    and the assembled blocks against the JAX operator, 1e-10."""
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    dj, dt = _pair("goddard", "gauss_legendre_2_constant_control", 5)
    x = _kkt_inputs(dj, problem_j("goddard").init)
    kj, kt = SJ(dj), ST(dt)
    assert (kt.d.bs, kt.d.wb) == (kj.d.bs, kj.d.wb) == (19, 8)
    data_j = kj.prepare(*(jnp.asarray(x[k]) for k in ("z", "lam")), jnp.asarray(0.7), jnp.asarray(x["sc"]))
    data_t = kt.prepare(t(x["z"]), t(x["lam"]), 0.7, t(x["sc"]))
    for key in ("Hloc", "Jloc", "Hb", "Jfp", "Jbc"):
        np.testing.assert_allclose(n(data_t[key]), np.asarray(data_j[key]), rtol=1e-10, atol=1e-10,
                                   err_msg=key)
    rest = ("sigma", "Drow")
    blocks_j = kj._assemble(data_j, *(jnp.asarray(x[k]) for k in rest), 1e-6, 1e-7,
                            jnp.asarray(x["rz"]), jnp.asarray(x["rp"]))
    blocks_t = kt._assemble(data_t, *(t(x[k]) for k in rest), 1e-6, 1e-7, t(x["rz"]), t(x["rp"]))
    for name, a, b in zip("ABEFr", blocks_t, blocks_j):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-10, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(n(blocks_t[5]), np.asarray(blocks_j[5]), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("scheme", ["gauss_legendre_2", "gauss_legendre_3_constant_control"])
def test_structured_direction_of_goddard_gl_matches_dense(scheme):
    """The structured CR direction with stage variables == the port's dense
    KKT oracle (after tests/test_torch_kkt.py::test_direction_matches_dense)."""
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.kkt import DenseKKT
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    _, d = _pair("goddard", scheme, 4)
    x = _kkt_inputs(d, get_problem("goddard").init)
    dense = DenseKKT(d.nlp_objective, d.constraints, d.nz, d.nc)
    struct = StructuredKKT(d, algorithm="cr")
    z, lam, sc = t(x["z"]), t(x["lam"]), t(x["sc"])
    sf = torch.tensor(0.7, dtype=torch.float64)
    rest = (t(x["sigma"]), t(x["Drow"]), 1e-6, 1e-7, t(x["rz"]), t(x["rp"]))
    dz_d, dl_d = dense.solve(dense.prepare(z, lam, sf, sc), *rest)
    dz_s, dl_s = struct.solve(struct.prepare(z, lam, sf, sc), *rest)
    np.testing.assert_allclose(n(dz_s), n(dz_d), atol=1e-9 * (1 + np.abs(n(dz_d)).max()))
    np.testing.assert_allclose(n(dl_s), n(dl_d), atol=1e-9 * (1 + np.abs(n(dl_d)).max()))
    assert struct.block_solves == 1
