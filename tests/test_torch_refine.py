"""Ruiz equilibration, iterative refinement and the f32 assembly of the
structured KKT operator, in the port against the JAX package (CPU).

- `_ruiz_scales`, `_apply_scales`, `_block_matvec` on a random symmetric
  chain (the CR recurrences assume symmetric blocks): the same elementwise
  maxima and products, 1e-14 relative; the matvec sums in another order,
  1e-12;
- `StructuredKKT.solve` with an f32 block solve, 2 refinement sweeps and Ruiz
  against the port's f64 dense direction and against the JAX operator in the
  same configuration. The f32 roundings of XLA and of torch differ, so the
  bound is relative: 1e-8 of the direction's max;
- `assemble_dtype=torch.float32` (the warm resolve's option) against JAX
  and against the f64 direction: each package lands ~2e-4 from the f64
  direction (f32 rounding of the assembled blocks), so 1e-3 relative;
- `BatchSolver` with `kkt_solve_dtype="f32"` at B=4 against four unbatched
  port solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, random_chain_lanes, t

SCHEME = "gauss_legendre_2_constant_control"


def _chain(N=6, bs=5, wb=3, seed=4):
    """One instance of a random symmetric chain, batch-major numpy."""
    A, Bp, E, F, r, rb = (x[..., 0] for x in random_chain_lanes(N, bs, wb, 1, seed=seed))
    rng = np.random.default_rng(seed)
    # spread the row scales over decades, as the IPM's Sigma does
    s = 10.0 ** rng.uniform(-3, 3, N * bs + wb)
    ss, sb = s[: N * bs].reshape(N, bs), s[N * bs :]
    A = A * ss[:, :, None] * ss[:, None, :]
    Bc = Bp[: N - 1] * ss[:-1, :, None] * ss[1:, None, :]
    E = E * ss[:, :, None] * sb[None, None, :]
    F = F * sb[:, None] * sb[None, :]
    X = rng.standard_normal((N, bs))
    xb = rng.standard_normal(wb)
    return (A, Bc, E, F, r, rb), X, xb


def test_ruiz_scales_and_apply_match_jax():
    from ctdirect_tpu.solver import structured_kkt as kj
    from ctdirect_tpu_torch.solver import structured_kkt as kt

    blocks, _, _ = _chain()
    dj = kj._ruiz_scales(*(jnp.asarray(b) for b in blocks[:4]))
    dt = kt._ruiz_scales(*(t(b) for b in blocks[:4]))
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-14, atol=0)
    out_j = kj._apply_scales(*(jnp.asarray(b) for b in blocks), *dj)
    out_t = kt._apply_scales(*(t(b) for b in blocks), *dt)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-14, atol=0)
    # two passes take the row inf-norms from a spread of > 1e5 to [1e-2, 1]
    def row_norms(blocks):
        return torch.cat([1.0 / d.reshape(-1) ** 2 for d in kt._ruiz_scales(*blocks[:4])])

    before = row_norms([t(b) for b in blocks])
    twice = kt._apply_scales(*out_t, *kt._ruiz_scales(*out_t[:4]))
    after = row_norms(twice)
    assert float(before.max() / before.min()) > 1e5
    assert 1e-2 < float(after.min()) and float(after.max()) <= 1.0 + 1e-12


@pytest.mark.parametrize("N", [1, 6])
def test_block_matvec_matches_jax_and_dense(N):
    from ctdirect_tpu.solver import structured_kkt as kj
    from ctdirect_tpu_torch.solver import structured_kkt as kt

    blocks, X, xb = _chain(N=N)
    A, Bc, E, F = blocks[:4]
    yj, ybj = kj._block_matvec(*(jnp.asarray(b) for b in (A, Bc, E, F, X, xb)))
    yt, ybt = kt._block_matvec(*(t(b) for b in (A, Bc, E, F, X, xb)))
    np.testing.assert_allclose(n(yt), np.asarray(yj), rtol=1e-12, atol=1e-12 * np.abs(yj).max())
    np.testing.assert_allclose(n(ybt), np.asarray(ybj), rtol=1e-12, atol=1e-12 * np.abs(ybj).max())
    # and the dense product of the reassembled system
    bs, wb = A.shape[1], E.shape[2]
    K = np.zeros((N * bs + wb,) * 2)
    for i in range(N):
        K[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = A[i]
        K[i * bs:(i + 1) * bs, N * bs:] = E[i]
        K[N * bs:, i * bs:(i + 1) * bs] = E[i].T
        if i + 1 < N:
            K[i * bs:(i + 1) * bs, (i + 1) * bs:(i + 2) * bs] = Bc[i]
            K[(i + 1) * bs:(i + 2) * bs, i * bs:(i + 1) * bs] = Bc[i].T
    K[N * bs:, N * bs:] = F
    y = K @ np.concatenate([X.reshape(-1), xb])
    np.testing.assert_allclose(np.concatenate([n(yt).reshape(-1), n(ybt)]), y, rtol=0,
                               atol=1e-12 * np.abs(y).max())


def _kkt_case(seed=5):
    """Goddard GL2-constant-control at N=5 in both packages, and KKT inputs
    whose Sigma spans 12 decades (an IPM iterate near active bounds)."""
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    dj = transcribe_j(problem_j("goddard").ocp, grid_size=5, scheme=SCHEME)
    dt = transcribe_t(problem_t("goddard").ocp, grid_size=5, scheme=SCHEME, device="cpu")
    rng = np.random.default_rng(seed)
    x = dict(
        z=dj.initial_guess(problem_j("goddard").init) + 0.01 * rng.standard_normal(dj.nz),
        lam=rng.standard_normal(dj.nc),
        sc=rng.uniform(0.5, 1.0, dj.nc),
        sigma=10.0 ** rng.uniform(-6, 6, dj.nz),
        Drow=rng.uniform(0.0, 1e-3, dj.nc),
        rz=rng.standard_normal(dj.nz),
        rp=rng.standard_normal(dj.nc),
    )
    return dj, dt, x


def _solve_t(kt, x):
    data = kt.prepare(t(x["z"]), t(x["lam"]), 0.7, t(x["sc"]))
    rest = (t(x["sigma"]), t(x["Drow"]), 1e-8, 1e-8, t(x["rz"]), t(x["rp"]))
    return tuple(n(a) for a in kt.solve(data, *rest))


def _solve_j(kj, x):
    """The JAX operator's prepare + solve, jitted (its eager ops are slow)."""
    def run(z, lam, sc, sigma, Drow, rz, rp):
        return kj.solve(kj.prepare(z, lam, 0.7, sc), sigma, Drow, 1e-8, 1e-8, rz, rp)

    args = (x[k] for k in ("z", "lam", "sc", "sigma", "Drow", "rz", "rp"))
    return tuple(np.asarray(a) for a in jax.jit(run)(*(jnp.asarray(a) for a in args)))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("algorithm", ["cr", "scan"])
def test_f32_refined_equilibrated_solve(algorithm):
    """f32 block solve + 2 refinement sweeps + Ruiz == the f64 dense
    direction and == JAX's operator in the same configuration, to 1e-8
    relative; without refinement the f32 direction is visibly worse."""
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.kkt import DenseKKT
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    dj, dt, x = _kkt_case()
    dense = DenseKKT(dt.nlp_objective, dt.constraints, dt.nz, dt.nc)
    ref = _solve_t(dense, x)
    kt = ST(dt, algorithm=algorithm, solve_dtype=torch.float32, refine=2)
    assert kt.equilibrate  # on by default for a reduced solve dtype
    got = _solve_t(kt, x)
    assert kt.block_solves == 3  # 1 + refine, all in f32
    kj = SJ(dj, algorithm=algorithm, solve_dtype=jnp.float32, refine=2)
    want = _solve_j(kj, x)
    for g, w, r in zip(got, want, ref):
        assert _rel(g, r) < 1e-8
        assert _rel(g, w) < 1e-8
    bare = _solve_t(ST(dt, algorithm=algorithm, solve_dtype=torch.float32, equilibrate=False), x)
    assert _rel(bare[0], ref[0]) > 100 * _rel(got[0], ref[0])


def test_assemble_dtype_float32_matches_jax():
    """assemble_dtype=float32 runs prepare and assembly in f32 (the warm
    resolve's configuration: f32 solve, no refinement, no Ruiz): the port's
    direction agrees with JAX's and with the f64 one to f32 accuracy."""
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    dj, dt, x = _kkt_case()
    x["sigma"] = np.random.default_rng(0).uniform(0.1, 2.0, dj.nz)  # a mildly conditioned system
    kt = ST(dt, solve_dtype=torch.float32, equilibrate=False, assemble_dtype=torch.float32)
    data = kt.prepare(t(x["z"]), t(x["lam"]), 0.7, t(x["sc"]))
    assert all(v.dtype == torch.float32 for v in data.values())
    got = _solve_t(kt, x)
    assert all(a.dtype == np.float64 for a in got)  # the step comes back in the DOCP's dtype
    want = _solve_j(SJ(dj, solve_dtype=jnp.float32, equilibrate=False, assemble_dtype=jnp.float32), x)
    ref = _solve_t(ST(dt), x)
    for g, w, r in zip(got, want, ref):
        assert _rel(g, w) < 1e-3
        assert _rel(g, r) < 1e-3


def test_batch_solver_f32_matches_unbatched():
    """BatchSolver with the f32 refined + equilibrated CR solve at B=4 ==
    four unbatched port solves, instance by instance (status, iterations;
    objective to 1e-10 relative), with one batched block solve per operator
    call."""
    from ctdirect_tpu_torch import IPMOptions, transcribe
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.interface import _get_solver

    p = get_problem("fuller")
    d = transcribe(p.ocp, grid_size=12, scheme="trapeze", device="cpu")
    opts = IPMOptions(tol=1e-8, max_iter=80, kkt_mode="cr", kkt_solve_dtype="f32")
    rng = np.random.default_rng(2)
    rows = d.boundary_row_indices()[: d.n]
    cl, cu = np.tile(d._c_lb, (4, 1)), np.tile(d._c_ub, (4, 1))
    dx = 0.05 * rng.standard_normal((4, d.n))
    dx[0] = 0.0
    cl[:, rows] += dx
    cu[:, rows] += dx
    z0 = np.tile(d.initial_guess(p.init), (4, 1))
    solver = BatchSolver(d, opts, device="cpu")
    res = solver(z0, cl, cu)
    # the LSQ multiplier init is one unrefined block solve; every Newton
    # system takes 1 + kkt_refine, each one batched call for all instances
    st = solver.stats
    assert solver.kkt.block_solves == 1 + (1 + opts.kkt_refine) * (st.kkt_solves - 1)
    run = _get_solver(d, opts)
    for b in range(4):
        r, _ = run(z0[b], d._z_lb, d._z_ub, cl[b], cu[b])
        assert int(r.status) == int(res.status[b]) == 0
        assert int(r.iterations) == int(res.iterations[b])
        np.testing.assert_allclose(float(res.objective[b]), float(r.objective), rtol=1e-10)
