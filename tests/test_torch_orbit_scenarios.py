"""BASELINE config 4 (ctdirect_tpu_torch/orbit_scenarios.py, the port of
benchmarks/orbit_scenarios.py): orbit_transfer, midpoint, a batch of
scenarios each with its own initial state (boundary rows of cl / cu) and
tf deadline (zu's last entry).

On the CPU, float64: the port's scenarios are bitwise the reference's
construction rebuilt on the JAX DOCP; the KKT operator that the card runs
(the CR StructuredKKT on this chain, vmapped) matches the JAX package's at
a well-conditioned point, and the port's CR matches the JAX package's on
the first KKT system of the batch; the port's BatchSolver matches the JAX
BatchSolver on the first rows of the B=2048 draw at N=40, both warm from
the JAX package's own nominal solve; and rows of the port's batch give
every row its result wherever it sits. Block elimination is unstable on
the batch's first KKT system (the module docstring of
ctdirect_tpu_torch/orbit_scenarios.py; tests/orbit_cpu_reference.py prints
the numbers): the CR's relative residual there is ~3e-3 in both packages,
and one ulp on its blocks moves the CR's step by ~1e4. So two CR batches
whose assembly rounds differently part by O(1) at the first iteration
(z 7.2 apart between the packages), and the batch is held to the JAX
package under the dense KKT solve (the one the reference's BatchSolver
runs for kkt_mode="cr"; the packages' first steps agree to 4e-12) over
PARITY_ITERS iterations, where the iterates still agree to ~3e-11 (the
third parts them by ~6e-9). The `cuda`-marked test runs the script's run
and checks on a card at N=500, B=64 (no JAX needed: `python -m pytest
--noconftest -p no:cacheprovider -m cuda
tests/test_torch_orbit_scenarios.py`)."""

import functools

import numpy as np
import pytest
import torch

from torch_helpers import check_batch_solver_matches_jax, jax_docp, n, t, torch_docp

N = 40  # the reference's N=500 cut for the CPU (the chain P=64 instead of 512)
DRAW = 2048  # the reference's batch: the rows below are rows of its draw
SIGMA = 1e-3
ROWS = 4
PARITY_ITERS = 2


def reference_scenarios(dj, z_nom, B=DRAW, sigma=SIGMA, seed=0):
    """benchmarks/orbit_scenarios.py:74-91, line for line, on the JAX DOCP."""
    rng = np.random.default_rng(seed)
    rows = dj.boundary_row_indices()[:4]
    cl = np.tile(dj._c_lb, (B, 1))
    cu = np.tile(dj._c_ub, (B, 1))
    dx0 = sigma * rng.standard_normal((B, 4))
    cl[:, rows] += dx0
    cu[:, rows] += dx0
    zl = np.tile(dj._z_lb, (B, 1))
    zu = np.tile(dj._z_ub, (B, 1))
    zu[:, -1] = 15.0 + rng.uniform(-1.0, 1.0, B)
    return np.broadcast_to(np.asarray(z_nom), (B,) + np.asarray(z_nom).shape), cl, cu, zl, zu


@functools.lru_cache(maxsize=None)
def jax_rows(rows=ROWS):
    """Rows 0..rows-1 of the reference's B=2048 draw at N=40, warm from the
    JAX package's own nominal solve (550 iterations, ~20 s)."""
    from ctdirect_tpu import InitialGuess
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions
    from ctdirect_tpu_torch.orbit_scenarios import NOMINAL_OPTS

    dj = jax_docp("orbit_transfer", N, "midpoint")
    nominal = solve_docp(dj, init=get_problem("orbit_transfer").init, options=IPMOptions(**NOMINAL_OPTS))
    assert nominal.successful
    z_nom = dj.initial_guess(InitialGuess.from_solution(nominal))
    return tuple(np.ascontiguousarray(x[:rows]) for x in reference_scenarios(dj, z_nom))


def first_cr_system(dt, inputs):
    """The lane-minor blocks (A, B, E, F, r, rb; batch axis last) of the
    first CR solve of the port's config-4 batch over `inputs`, one
    iteration, on the CPU."""
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.solver import cr_kernel
    from ctdirect_tpu_torch.solver.ipm import IPMOptions
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    seen, plain = [], cr_kernel.cr_solve_batched

    def spy(*chain):
        seen.append([x.clone() for x in chain])
        return plain(*chain)

    cr_kernel.cr_solve_batched = spy
    try:
        opts = IPMOptions(tol=1e-6, max_iter=1, lsq_lambda_init=False)
        BatchSolver(dt, opts, kkt=StructuredKKT(dt, algorithm="cr"), device="cpu")(*inputs)
    finally:
        cr_kernel.cr_solve_batched = plain
    return seen[0]


def test_make_scenarios_is_the_reference_construction():
    from ctdirect_tpu_torch.orbit_scenarios import make_scenarios

    dj = jax_docp("orbit_transfer", N, "midpoint")
    dt = torch_docp("orbit_transfer", N, "midpoint")
    np.testing.assert_array_equal(dt.boundary_row_indices(), dj.boundary_row_indices())
    got = make_scenarios(dt, DRAW, SIGMA, seed=0)
    want = reference_scenarios(dj, dj.initial_guess())
    for name, g, w in zip(("z0", "cl", "cu", "zl", "zu"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        np.testing.assert_array_equal(n(g), w, err_msg=name)
    # every scenario has its own deadline and initial state
    assert len(np.unique(n(got[4])[:, -1])) == DRAW
    assert len(np.unique(n(got[1])[:, dj.boundary_row_indices()[0]])) == DRAW
    # the draws' order: U(-1, 1) follows the B x 4 normals, so a smaller
    # batch gives other deadlines to its first rows
    small = make_scenarios(dt, 16, SIGMA, seed=0)
    np.testing.assert_array_equal(n(small[1]), n(got[1])[:16])
    assert not np.array_equal(n(small[4]), n(got[4])[:16])


def test_batch_matches_jax_on_the_first_rows_of_the_draw():
    check_batch_solver_matches_jax("orbit_transfer", scheme="midpoint", inputs=lambda dj: jax_rows(), dense=True,
                                   tol=1e-6, max_iter=PARITY_ITERS, lsq_lambda_init=False)


def test_cr_operator_matches_jax_on_the_config4_chain():
    """The KKT operator that the card runs on this workload,
    StructuredKKT(algorithm="cr") on orbit_transfer's midpoint chain (bs=11,
    wb=13 at any N; N=8 here, P=8), prepare and solve vmapped over 3 rows as
    BatchSolver runs them, against the JAX package's on the same data:
    random multipliers, barrier terms and right-hand sides near the
    fixture's guess (a well-conditioned point: test_torch_kkt.py's kind),
    1e-10 x scale."""
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    dj, dt = jax_docp("orbit_transfer", 8, "midpoint"), torch_docp("orbit_transfer", 8, "midpoint")
    kj, kt = SJ(dj, algorithm="cr"), ST(dt, algorithm="cr")
    assert (kt.d.bs, kt.d.wb) == (11, 13)
    rng = np.random.default_rng(7)
    rows = 3
    x = dict(z=dj.initial_guess() + 0.01 * rng.standard_normal((rows, dj.nz)),
             lam=rng.standard_normal((rows, dj.nc)), sc=rng.uniform(0.5, 1.0, (rows, dj.nc)),
             sigma=rng.uniform(0.1, 2.0, (rows, dj.nz)), Drow=rng.uniform(0.0, 1.0, (rows, dj.nc)),
             rz=rng.standard_normal((rows, dj.nz)), rp=rng.standard_normal((rows, dj.nc)))
    order = ("z", "lam", "sc", "sigma", "Drow", "rz", "rp")

    def step(k, z, lam, sc, sigma, Drow, rz, rp):
        return k.solve(k.prepare(z, lam, 0.7, sc), sigma, Drow, 1e-8, 1e-8, rz, rp)

    dz_j, dl_j = jax.vmap(lambda *a: step(kj, *a))(*(jnp.asarray(x[k]) for k in order))
    dz_t, dl_t = torch.func.vmap(lambda *a: step(kt, *a))(*(t(x[k]) for k in order))
    for got, want in ((dz_t, dz_j), (dl_t, dl_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-10 * (1 + np.abs(want).max()))


def test_cr_matches_jax_on_the_first_kkt_system_of_the_batch():
    """Where the two batches part: the blocks of the first CR solve of the
    port's config-4 batch (rows 0-3 of the draw, warm from the JAX
    package's N=40 nominal), solved by the port's CR (the kernel's plain
    version) and by the JAX package's, agree to 1e-10 x scale (bit for bit
    in my CPU run), and so do their relative residuals. Both are
    inaccurate on this system (residual ~3e-3 against the dense solve's
    ~1e-18, tests/orbit_cpu_reference.py): the step of a block
    elimination moves by O(1) where its input moves by one ulp, so the two
    packages' batches, whose assembly rounds differently, part from here."""
    import jax.numpy as jnp

    from ctdirect_tpu.solver.lanes import cr_solve_lanes as cr_j
    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes as cr_t
    from torch_helpers import relative_residual

    chain = first_cr_system(torch_docp("orbit_transfer", N, "midpoint"), jax_rows())
    assert tuple(chain[0].shape) == (64, 11, 11, ROWS) and tuple(chain[3].shape) == (13, 13, ROWS)
    Xt, xbt = cr_t(*chain)
    Xj, xbj = (np.asarray(v) for v in cr_j(*(jnp.asarray(n(c)) for c in chain)))
    for got, want in ((Xt, Xj), (xbt, xbj)):
        np.testing.assert_allclose(n(got), want, rtol=0, atol=1e-10 * (1 + np.abs(want).max()))
    for lane in range(ROWS):
        res_t, res_j = relative_residual(chain, Xt, xbt, lane), relative_residual(chain, Xj, xbj, lane)
        assert abs(res_t - res_j) <= 1e-10 * res_j, lane


def test_batch_rows_do_not_depend_on_their_position():
    """The script's per-row check on the CPU: the config-4 batch (rows 0-7
    of a B=8 draw, the CR solve, 30 iterations, from the DOCP's default
    guess: the nominal solve takes minutes here) with its rows shifted by
    one and by ALIGN_PERIOD, and moved at random within their alignment
    classes as the script moves them on the card, gives every row its
    result bit for bit."""
    from ctdirect_tpu_torch.orbit_scenarios import ALIGN_PERIOD, DEFAULT_CFG, aligned_permutation, batch_options
    from ctdirect_tpu_torch.orbit_scenarios import make_scenarios
    from ctdirect_tpu_torch.parallel import BatchSolver

    dt = torch_docp("orbit_transfer", N, "midpoint")
    inputs = make_scenarios(dt, 8, SIGMA, seed=0)
    solver = BatchSolver(dt, batch_options(DEFAULT_CFG), device="cpu")
    res = solver(*inputs)
    for rows in (np.roll(np.arange(8), 1), np.roll(np.arange(8), ALIGN_PERIOD), aligned_permutation(8, seed=1)):
        rows = torch.as_tensor(rows)
        moved = solver(*(x[rows] for x in inputs))
        for field, got, want in zip(res._fields, moved, res):
            assert torch.equal(got, want[rows]), (rows, field)
    assert len(set(n(res.objective).tolist())) == 8


@pytest.mark.parametrize("B", [8, 2048])
def test_aligned_permutation_keeps_each_row_in_its_class(B):
    """The script's row move: a permutation that keeps b mod ALIGN_PERIOD
    and, at the script's size, gives almost every row another place."""
    from ctdirect_tpu_torch.orbit_scenarios import ALIGN_PERIOD, aligned_permutation

    perm = aligned_permutation(B)
    np.testing.assert_array_equal(np.sort(perm), np.arange(B))
    np.testing.assert_array_equal(perm % ALIGN_PERIOD, np.arange(B) % ALIGN_PERIOD)
    assert (perm != np.arange(B)).mean() >= (0.99 if B == 2048 else 0.25)
    np.testing.assert_array_equal(aligned_permutation(B), perm)  # seeded


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the batch's graphs and the CR kernel have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_orbit_scenarios_run_and_checks_on_card(card):
    """The script's run and checks at full width with a small batch: N=500,
    B=64, the nominal on the CR solve (~8 s on the card; the structured one
    takes ~210 s). At N=40 the card's nominal found another local optimum,
    0.4264 against the JAX package's 0.4707 (PERF.md)."""
    from ctdirect_tpu_torch import orbit_scenarios

    cfg = dict(orbit_scenarios.DEFAULT_CFG, N=500, B=64, nominal_mode="cr")
    result = orbit_scenarios.run(cfg, device=card)
    summary = orbit_scenarios.report(result, cfg)
    assert summary["B"] == 64 and (summary["P"], summary["bs"], summary["wb"]) == (512, 11, 13)
    assert all(c["launches"] > 0 for c in summary["calls"].values())
    assert summary["profiled"]["cr_launches"] > 0 and "CR kernel" in summary["stages"]
