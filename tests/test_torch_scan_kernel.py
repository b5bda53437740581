"""The structured solve's sequential block elimination ("scan"): the port's
plain `_scan_solve` against the JAX package's and against the C++ native
solver, the dispatch's `vmap` rule, the exact row exchange of its
Gauss-Jordan, a model of the kernel's warp Gauss-Jordan (rows exchanged by
their indices) against the plain one, the port's `native` module, the
kernel wrapper's CPU behaviour, and the CUDA kernel against its plain
version and each batched chain against itself alone on the card (marked
`cuda`, skipped without one).

The JAX package is imported inside the tests that compare with it, so the
card tests run where JAX is missing: `python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_scan_kernel.py`."""

import numpy as np
import pytest
import torch
from torch.func import vmap

from torch_helpers import n, random_chain_lanes, relative_residual, t

from ctdirect_tpu_torch import native as native_t
from ctdirect_tpu_torch.solver import lanes, scan_kernel
from ctdirect_tpu_torch.solver.kkt import _gj_eliminate
from ctdirect_tpu_torch.solver.scan_kernel import scan_solve, scan_solve_batched
from ctdirect_tpu_torch.solver.structured_kkt import _scan_solve

# f64 agreement with the JAX package's and the C++ solve: x (1 + max |x|)
TOL = 1e-10


def _batch_major(N, bs, wb, B, seed, dtype=np.float64):
    """A random symmetric chain (torch_helpers.random_chain_lanes) as numpy,
    batch first: A (B,N,bs,bs), Bc (B,N-1,bs,bs), E (B,N,bs,wb), F (B,wb,wb),
    r (B,N,bs), rb (B,wb)."""
    A, Bp, E, F, r, rb = random_chain_lanes(N, bs, wb, B, seed=seed, dtype=dtype)
    return tuple(np.ascontiguousarray(np.moveaxis(x, -1, 0)) for x in (A, Bp[: N - 1], E, F, r, rb))


def _lanes(chain):
    """A batch-major chain as the lane-minor one of torch_helpers (the
    coupling padded with a zero last block), for its residual oracle."""
    A, Bc, E, F, r, rb = (np.moveaxis(np.asarray(x), 0, -1) for x in chain)
    Bp = np.concatenate([Bc, np.zeros_like(A[:1])], axis=0)
    return A, Bp, E, F, r, rb


def _jax_blocks(name, scheme, gs, seed=7):
    """The assembled (A, B, E, F, r, rb) of a JAX DOCP at a random point
    (tests/test_native.py::_blocks's recipe), numpy."""
    jnp = pytest.importorskip("jax.numpy")
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT

    rng = np.random.default_rng(seed)
    p = get_problem(name)
    d = transcribe(p.ocp, grid_size=gs, scheme=scheme)
    kkt = StructuredKKT(d)
    z = jnp.asarray(d.initial_guess(p.init) + 0.01 * rng.standard_normal(d.nz))
    lam = jnp.asarray(rng.standard_normal(d.nc))
    data = kkt.prepare(z, lam, jnp.asarray(1.0), jnp.ones(d.nc))
    sigma = jnp.asarray(rng.uniform(0.1, 2.0, d.nz))
    Drow = jnp.asarray(rng.uniform(0.0, 1.0, d.nc))
    rz = jnp.asarray(rng.standard_normal(d.nz))
    rp = jnp.asarray(rng.standard_normal(d.nc))
    return tuple(np.asarray(x) for x in kkt._assemble(data, sigma, Drow, 1e-6, 1e-7, rz, rp))


def _tiny_row_chain(bs=6, wb=2, seed=5, dtype=np.float64):
    """A one-block chain (batch-major, B=1) whose system row 0 is scaled by
    2^-66 (exact): row 0 of A_0 and of the right-hand side, with row 0 of
    E_0 zero, so that the solution is that of the unscaled system. Column 0
    has its maximum in row 1, so the first pivot exchanges rows 0 and 1.
    Exchanged exactly (the structured solve's Gauss-Jordan), row 1 keeps the
    tiny row; by the CR's one-hot form row_p + (row_j - row_p) it becomes 0
    (each entry of the tiny row is below half an ulp of row 1's), the
    system singular and the solve not finite."""
    A, Bc, E, F, r, rb = _batch_major(1, bs, wb, 1, seed, dtype)
    A[0, 0, 1, 0] = A[0, 0, 0, 1] = 8.0
    A[0, 0, 0] *= dtype(2.0**-66)
    r[0, 0, 0] *= dtype(2.0**-66)
    E[0, 0, 0] = 0.0
    return A, Bc, E, F, r, rb


def _tie_block(bs=7, seed=3):
    """A well-conditioned symmetric block whose first column has equal
    magnitudes in rows 2, 4 and 5 (4, -4, 4) above the rest: the pivot is
    the first of them (argmax's first maximum); the later columns tie as
    well (entries sums of five values)."""
    rng = np.random.default_rng(seed)
    while True:
        R = rng.choice([-0.3, -0.1, 0.1, 0.3, 0.7], size=(bs, bs))
        M = R + R.T
        M[:, 0] = M[0, :] = 0.5
        M[2, 0], M[4, 0], M[5, 0] = 4.0, -4.0, 4.0
        M[0, 2], M[0, 4], M[0, 5] = 4.0, -4.0, 4.0
        if np.linalg.cond(M) < 1e3:
            return M


def _docp_chain(name, N, sigma, seed=7, device="cuda"):
    """The assembled chain of a port DOCP (trapeze) at a random point, as
    tests/test_native.py::_blocks makes the JAX package's, batch-major (B=1)
    on `device`; `sigma` scales the barrier diagonal and the constraint
    regularisation (small sigma: the blocks of a late IPM iteration, which
    pivot off the diagonal)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    rng = np.random.default_rng(seed)
    p = get_problem(name)
    d = ct.transcribe(p.ocp, grid_size=N, scheme="trapeze", device=device)
    kkt = StructuredKKT(d)

    def dev(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    z = dev(np.asarray(d.initial_guess(p.init)) + 0.01 * rng.standard_normal(d.nz))
    data = kkt.prepare(z, dev(rng.standard_normal(d.nc)), 1.0, torch.ones(d.nc, dtype=torch.float64, device=device))
    blocks = kkt._assemble(data, dev(sigma * rng.uniform(0.1, 2.0, d.nz)), dev(sigma * rng.uniform(0.0, 1.0, d.nc)),
                           1e-8, 1e-9, dev(rng.standard_normal(d.nz)), dev(rng.standard_normal(d.nc)))
    return tuple(x[None].contiguous() for x in blocks)


@pytest.fixture(scope="module")
def systems():
    """The test systems: the assembled chains of two JAX DOCPs
    (double_integrator trapeze N=50, beam GL2 N=8), a random chain of
    quadrotor's width (bs=21, wb=28; N=6) and a chain whose every diagonal
    block has the tied pivot column of _tie_block."""
    out = {
        "double_integrator_trapeze_50": _jax_blocks("double_integrator_minenergy", "trapeze", 50),
        "beam_gl2_8": _jax_blocks("beam", "gauss_legendre_2", 8),
        "quadrotor_width": tuple(x[0] for x in _batch_major(6, 21, 28, 1, seed=2)),
    }
    A, Bc, E, F, r, rb = (x[0] for x in _batch_major(5, 7, 3, 1, seed=9))
    A[:] = _tie_block()
    out["tied_pivots"] = (A, Bc, E, F, r, rb)
    return out


SYSTEMS = ["double_integrator_trapeze_50", "beam_gl2_8", "quadrotor_width", "tied_pivots"]


def _close(got, want, tol=TOL):
    scale = 1.0 + max(np.abs(want[0]).max(), np.abs(want[1]).max() if want[1].size else 0.0)
    np.testing.assert_allclose(n(got[0]), want[0], rtol=0, atol=tol * scale)
    np.testing.assert_allclose(n(got[1]), want[1], rtol=0, atol=tol * scale)


@pytest.mark.parametrize("name", SYSTEMS)
def test_plain_scan_matches_jax(systems, name):
    """The port's plain scan, its dispatch and the wrapper on CPU tensors
    against the JAX package's `_scan_solve` on the same blocks."""
    jnp = pytest.importorskip("jax.numpy")
    from ctdirect_tpu.solver.structured_kkt import _scan_solve as scan_j

    blocks = systems[name]
    want = tuple(np.asarray(x) for x in scan_j(*(jnp.asarray(x) for x in blocks)))
    tb = tuple(t(x) for x in blocks)
    _close(_scan_solve(*tb), want)
    _close(scan_solve(*tb), want)
    X, xb = scan_solve_batched(*(x[None] for x in tb))
    _close((X[0], xb[0]), want)
    _close(native_t.blocktri_solve(*tb), want)


@pytest.mark.parametrize("name", SYSTEMS)
def test_plain_scan_matches_the_native_solver(systems, name):
    """The same systems against the JAX package's C++ block solver
    (`ctdirect_tpu.native`, built with g++), one instance and a batch of
    three (the third instance's right-hand side doubled)."""
    native_j = pytest.importorskip("ctdirect_tpu.native")
    if not native_j.available():
        pytest.skip("g++ toolchain unavailable")
    blocks = systems[name]
    want = native_j.blocktri_solve(*blocks)
    _close(_scan_solve(*(t(x) for x in blocks)), want)
    batch = [np.stack([x, x, 2.0 * x if i >= 4 else x]) for i, x in enumerate(blocks)]
    Xn, xbn = native_j.blocktri_solve_batch(*batch)
    X, xb = native_t.blocktri_solve_batch(*(t(x) for x in batch))
    for b in range(3):
        _close((X[b], xb[b]), (Xn[b], xbn[b]))
    _close((X[2], xb[2]), (2.0 * want[0], 2.0 * want[1]))


def test_native_modules_agree():
    """The port's native.blocktri_solve / _batch on the CPU against the
    JAX package's on a random batch."""
    native_j = pytest.importorskip("ctdirect_tpu.native")
    if not native_j.available():
        pytest.skip("g++ toolchain unavailable")
    batch = _batch_major(9, 5, 4, 4, seed=21)
    Xn, xbn = native_j.blocktri_solve_batch(*batch)
    _close(native_t.blocktri_solve_batch(*(t(x) for x in batch)), (Xn, xbn))
    for b in range(4):
        _close(native_t.blocktri_solve(*(t(x[b]) for x in batch)),
               native_j.blocktri_solve(*(x[b] for x in batch)))


@pytest.mark.parametrize("N", [1, 2, 7])
def test_vmap_rule_matches_per_instance_solves(N):
    """Under vmap the dispatch solves the whole batch in one call: equal to
    the unbatched solves of each instance, also with an operand broadcast
    (in_dims None)."""
    batch = tuple(t(x) for x in _batch_major(N, 4, 3, 5, seed=N))
    X, xb = vmap(scan_solve)(*batch)
    F0 = batch[3][0]
    Xf, xbf = vmap(scan_solve, in_dims=(0, 0, 0, None, 0, 0))(*batch[:3], F0, *batch[4:])
    for b in range(5):
        Xb, xbb = scan_solve(*(a[b] for a in batch))
        np.testing.assert_allclose(n(X[b]), n(Xb), rtol=0, atol=1e-13)
        np.testing.assert_allclose(n(xb[b]), n(xbb), rtol=0, atol=1e-13)
        Xc, xbc = scan_solve(*(a[b] for a in batch[:3]), F0, *(a[b] for a in batch[4:]))
        np.testing.assert_allclose(n(Xf[b]), n(Xc), rtol=0, atol=1e-13)
        np.testing.assert_allclose(n(xbf[b]), n(xbc), rtol=0, atol=1e-13)


def test_single_block_chain_matches_jax_and_a_dense_solve():
    """N=1: no coupling blocks (B has zero rows); the solve is the dense
    [[A, E], [E^T, F]] system's."""
    jnp = pytest.importorskip("jax.numpy")
    from ctdirect_tpu.solver.structured_kkt import _scan_solve as scan_j

    blocks = tuple(x[0] for x in _batch_major(1, 5, 3, 1, seed=4))
    assert blocks[1].shape == (0, 5, 5)
    want = tuple(np.asarray(x) for x in scan_j(*(jnp.asarray(x) for x in blocks)))
    _close(scan_solve(*(t(x) for x in blocks)), want)
    A, _, E, F, r, rb = blocks
    K = np.block([[A[0], E[0]], [E[0].T, F]])
    sol = np.linalg.solve(K, np.concatenate([r[0], rb]))
    _close(scan_solve(*(t(x) for x in blocks)), (sol[:5][None], sol[5:]))


def test_tied_pivots_exchange_exactly_as_the_jax_gauss_jordan():
    """The Gauss-Jordan of the structured solve on the tied block: the
    pivot is argmax's first maximum and rows exchange exactly, bit for bit
    a plain loop's, and the JAX package's `_gj_eliminate` to rounding (XLA
    rounds its rank-one update otherwise: 8.9e-16 apart here, where another
    pivot would move entries by O(1))."""
    jnp = pytest.importorskip("jax.numpy")
    from ctdirect_tpu.solver.kkt import _gj_eliminate as gj_j
    from torch_helpers import gj_loop

    A = _tie_block()
    M = np.concatenate([A, np.eye(7)], axis=1)
    got = n(_gj_eliminate(t(M), 7))
    assert np.array_equal(got, gj_loop(M, 7))
    np.testing.assert_allclose(got, np.asarray(gj_j(jnp.asarray(M), 7)), rtol=0, atol=1e-14)


def test_a_nan_column_pivots_as_argmax_does():
    """A NaN in the pivot column is argmax's maximum (its first NaN): it
    becomes the pivot, and its division spreads NaN over every entry, in
    the port's Gauss-Jordan as in the JAX package's. A search that passed
    over it (the CR kernel's keeps the diagonal for a column of NaNs) would
    leave the other rows finite at that column."""
    jnp = pytest.importorskip("jax.numpy")
    from ctdirect_tpu.solver.kkt import _gj_eliminate as gj_j

    M = np.concatenate([_tie_block(7, seed=1), np.eye(7)], axis=1)
    M[3, 1] = np.nan
    got = n(_gj_eliminate(t(M), 7))
    assert np.isnan(got).all() and np.isnan(np.asarray(gj_j(jnp.asarray(M), 7))).all()
    M[3, 1] = 1e3  # the largest entry instead: the rows stay finite
    assert np.isfinite(n(_gj_eliminate(t(M), 7))).all()


def test_exact_exchange_is_not_the_one_hot_form():
    """On the tiny-row chain the structured solve (exact exchange) solves
    the system to rounding, the JAX package's too, while the CR's one-hot
    exchange (lanes.cr_solve_lanes, the reference's pallas_cr.py form)
    zeroes the tiny row and returns no finite solution: a kernel that
    swapped as the CR kernel does would fail the card test below."""
    jnp = pytest.importorskip("jax.numpy")
    from ctdirect_tpu.solver.structured_kkt import _scan_solve as scan_j

    chain = _tiny_row_chain()
    blocks = tuple(t(x[0]) for x in chain)
    X, xb = scan_solve(*blocks)
    assert relative_residual(_lanes(chain), n(X)[..., None], n(xb)[..., None], 0) < 1e-13
    want = tuple(np.asarray(x) for x in scan_j(*(jnp.asarray(x[0]) for x in chain)))
    _close((X, xb), want)
    Xc, xbc = _one_hot_solve(chain)
    assert not (np.isfinite(n(Xc)).all() and np.isfinite(n(xbc)).all())


def _gj_index_exchange(M, n):
    """The scan kernel's warp Gauss-Jordan (`gj_warp` in csrc/scan_solve.cu)
    as a numpy model: the physical rows stay where they are and carry the
    logical index of the row they hold; the pivot is the first logical row
    of maximal |value| at or below the diagonal (a NaN first); the holders
    of rows j and p swap their indices; the pivot row is divided by its
    pivot and every other row loses its column-j multiple of it (a product
    and a difference, rounded apart); columns left of the pivot are not
    updated. Returns the reduced matrix in logical row order: its columns
    n and beyond are the result, the rest is never read."""
    M = np.array(M, dtype=np.float64)
    r = np.arange(n)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for j in range(n):
            best = None
            for a in sorted(range(n), key=lambda a: r[a]):
                if r[a] < j:
                    continue
                v, b = abs(M[a, j]), None if best is None else abs(M[best, j])
                if best is None or (np.isnan(v) and not np.isnan(b)) or (not np.isnan(b) and v > b):
                    best = a
            p = r[best]
            prow = M[best, j + 1 :] / M[best, j]
            holder_j = int(np.flatnonzero(r == j)[0])
            r[holder_j], r[best] = p, j
            for a in range(n):
                if a == best:
                    M[a, j + 1 :] = prow
                else:
                    M[a, j + 1 :] = M[a, j + 1 :] - M[a, j] * prow
    out = np.empty_like(M)
    out[r] = M
    return out


def _gj_cases():
    rng = np.random.default_rng(11)
    tie = np.concatenate([_tie_block(), np.eye(7)], axis=1)
    nan = np.concatenate([_tie_block(7, seed=1), np.eye(7)], axis=1)
    nan[3, 1] = np.nan
    inf = tie.copy()
    inf[5, 3] = np.inf
    wide = rng.standard_normal((12, 12)) + 4 * np.eye(12)
    border = rng.standard_normal((9, 10))  # [Ftil | rbtil]: w rows, w + 1 columns
    return {"ties": (tie, 7), "nan": (nan, 7), "inf": (inf, 7),
            "random": (np.concatenate([wide, np.eye(12)], axis=1), 12), "border": (border, 9)}


@pytest.mark.parametrize("case", ["ties", "nan", "inf", "random", "border"])
def test_the_kernels_index_exchange_equals_the_plain_gauss_jordan(case):
    """The kernel's Gauss-Jordan moves no row: it swaps the indices of the
    rows the lanes hold and leaves the columns left of the pivot as they
    are. Its result (the columns right of the square part) is the plain
    exact exchange's (`_gj_eliminate`, torch.argmax's pivot) bit for bit,
    with tied pivots, a NaN or an infinity in the matrix, and on a border
    system's shape."""
    M, rows = _gj_cases()[case]
    got = _gj_index_exchange(M, rows)[:, rows:]
    want = n(_gj_eliminate(t(M), rows))[:, rows:]
    assert np.array_equal(got, want, equal_nan=True)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def _one_hot_solve(chain):
    """The CR's plain version (one-hot exchange) on a one-block chain
    (batch-major)."""
    return lanes.cr_solve_lanes(*(t(x) for x in _lanes(chain)))


def test_structured_block_solves_call_the_wrapper_once_each(monkeypatch):
    """A `kkt_mode="structured"` KKT solve reaches the wrapper once per block
    solve, unbatched and for a whole vmapped batch (on a card, one kernel
    launch each), and its result is the plain scan's."""
    from torch_helpers import torch_docp

    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    calls = []

    def spy(*chain):
        calls.append(tuple(chain[0].shape))
        return scan_kernel.scan_solve_plain(*chain)

    d = torch_docp(grid_size=6)
    rng = np.random.default_rng(0)
    kkt = StructuredKKT(d)
    z, lam = t(d.initial_guess(None) + 0.01 * rng.standard_normal(d.nz)), t(rng.standard_normal(d.nc))
    data = kkt.prepare(z, lam, 1.0, torch.ones(d.nc, dtype=torch.float64))
    args = (t(rng.uniform(0.1, 2.0, d.nz)), t(rng.uniform(0.0, 1.0, d.nc)), 1e-6, 1e-7,
            t(rng.standard_normal(d.nz)), t(rng.standard_normal(d.nc)))
    want = kkt.solve(data, *args)
    monkeypatch.setattr(scan_kernel, "scan_solve_batched", spy)
    got = kkt.solve(data, *args)
    assert calls == [(1, d.N, kkt.d.bs, kkt.d.bs)] and kkt.block_solves == 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rz = torch.stack([args[4], 2.0 * args[4], -args[4]])
    dz, _ = vmap(lambda x: kkt.solve(data, *args[:4], x, args[5]))(rz)
    assert calls[1:] == [(3, d.N, kkt.d.bs, kkt.d.bs)] and kkt.block_solves == 3
    np.testing.assert_allclose(n(dz[0]), n(want[0]), rtol=0, atol=1e-13)


def test_every_width_has_one_library():
    """Widths up to EXACT_MAX are built one library each (the kernel
    specialised to that width), the wider ones share one; every width the
    kernel takes maps to a key that the parallel build covers."""
    keys = {scan_kernel.width_key(bs) for bs in range(1, scan_kernel.MAX_WIDTH + 1)}
    assert keys == set(scan_kernel.WIDTH_KEYS)
    assert [scan_kernel.width_key(bs) for bs in (1, 16, 17, 64)] == [1, 16, 0, 0]


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    batch = tuple(t(x) for x in _batch_major(6, 3, 2, 4, seed=1))
    X, xb = scan_solve_batched(*batch)
    Xp, xbp = vmap(_scan_solve)(*batch)
    assert torch.equal(X, Xp) and torch.equal(xb, xbp)
    X1, xb1 = scan_solve_batched(*(x[:1] for x in batch))
    Xs, xbs = _scan_solve(*(x[0] for x in batch))
    assert torch.equal(X1[0], Xs) and torch.equal(xb1[0], xbs)
    assert scan_solve_batched.launches == 0


def test_wrapper_rejects_other_devices_and_bad_chains():
    batch = tuple(t(x) for x in _batch_major(4, 3, 2, 2, seed=2))
    with pytest.raises(RuntimeError, match="unsupported device"):
        scan_solve_batched(*(x.to("meta") for x in batch))
    A, Bc, E, F, r, rb = batch
    with pytest.raises(ValueError, match="exceeds the cap"):
        scan_kernel.check_chain(*(x.new_zeros(s) for x, s in zip(
            batch, [(2, 4, 40, 40), (2, 3, 40, 40), (2, 4, 40, 25), (2, 25, 25), (2, 4, 40), (2, 25)])))
    with pytest.raises(ValueError, match="B has shape"):
        scan_kernel.check_chain(A, Bc[:, :2], E, F, r, rb)
    with pytest.raises(ValueError, match="not contiguous"):
        scan_kernel.check_chain(A, Bc, E, F.transpose(1, 2), r, rb)
    with pytest.raises(TypeError, match="float32 or float64"):
        scan_kernel.check_chain(*(x.half() for x in batch))
    with pytest.raises(ValueError, match="want torch.float64"):
        scan_kernel.check_chain(A, Bc.float(), E, F, r, rb)


# ---- the kernel on the card ----


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


# (N, bs, wb, B): the paths' shapes at test size (the MPC tick's chain, the
# cart-pole batch, quadrotor's and orbit_transfer's widths), N = 1 and 2,
# and widths up to the cap of 64 (no border, border only beside one column)
CARD_SHAPES = [
    (100, 5, 7, 64),
    (60, 9, 13, 130),
    (150, 21, 28, 1),
    (500, 11, 13, 1),
    (1, 5, 3, 3),
    (2, 4, 3, 33),
    (9, 64, 0, 2),
    (8, 40, 24, 3),
    (3, 1, 63, 2),
    (7, 1, 0, 5),
]


def _check_on_card(host, dtype, tol):
    chain = tuple(torch.tensor(x, device="cuda", dtype=dtype) for x in host)
    before = scan_solve_batched.launches
    X, xb = scan_solve_batched(*chain)
    assert scan_solve_batched.launches == before + 1
    Xp, xbp = scan_kernel.scan_solve_plain(*chain)
    torch.cuda.synchronize()
    assert torch.isfinite(X).all() and torch.isfinite(xb).all()
    scale = 1.0 + max(Xp.abs().max().item(), xbp.abs().max().item() if xbp.numel() else 0.0)
    assert (X - Xp).abs().max().item() <= tol * scale
    if xb.numel():
        assert (xb - xbp).abs().max().item() <= tol * scale
    bound = 2e-4 if dtype == torch.float32 else 1e-12
    lane_chain = _lanes(host)
    for b in (0, host[0].shape[0] - 1):
        assert relative_residual(lane_chain, n(X).transpose(1, 2, 0), n(xb).T, b) < bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-10)])
@pytest.mark.parametrize("N,bs,wb,B", CARD_SHAPES)
def test_kernel_matches_plain_on_card(N, bs, wb, B, dtype, tol):
    _needs_card()
    _check_on_card(_batch_major(N, bs, wb, B, seed=N + bs), dtype, tol)


# batch sizes: 1 and a few that are no multiple of the chains a CTA holds
# (ceil(B / SMs), at most 4: on 132 SMs 1, 1, 1, 2 and 4 for 3, 33, 130, 133
# and 397); the chain widths of three width classes of the kernel
BATCHES = [1, 3, 33, 130, 133, 397]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,bs,wb", [(12, 5, 7), (20, 11, 13), (4, 40, 24)])
@pytest.mark.parametrize("B", BATCHES)
def test_kernel_batch_rows_equal_each_chain_alone_on_card(B, N, bs, wb, dtype):
    """Each row of a batched solve is bit for bit the same chain solved
    alone (B=1): a chain's result depends neither on its CTA-mates nor on
    its slot in the CTA."""
    _needs_card()
    host = _batch_major(N, bs, wb, B, seed=B + bs)
    chain = tuple(torch.tensor(x, device="cuda", dtype=dtype) for x in host)
    X, xb = scan_solve_batched(*chain)
    for b in range(B):
        Xb, xbb = scan_solve_batched(*(x[b : b + 1].contiguous() for x in chain))
        assert torch.equal(Xb[0], X[b]) and torch.equal(xbb[0], xb[b]), f"row {b} of {B}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_exchanges_rows_exactly_on_card(dtype):
    """The tiny-row chain: the kernel's solve is finite and the plain
    scan's to rounding (the one-hot form would zero the row)."""
    _needs_card()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    _check_on_card(_tiny_row_chain(dtype=np_dtype), dtype, 1e-3 if dtype == torch.float32 else 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [1.0, 1e-6])
@pytest.mark.parametrize("name,N", [("quadrotor", 30), ("space_shuttle", 30), ("algal_bacterial", 50),
                                    ("orbit_transfer", 75), ("goddard", 100)])
def test_kernel_matches_plain_on_docp_chains_on_card(name, N, sigma):
    """Assembled KKT chains of the structured CI's fixtures on the card
    (indefinite blocks that pivot off the diagonal): the kernel against its
    plain version, f64, and its residual no more than 10x the plain one's."""
    _needs_card()
    chain = _docp_chain(name, N, sigma)
    X, xb = scan_solve_batched(*chain)
    Xp, xbp = scan_kernel.scan_solve_plain(*chain)
    torch.cuda.synchronize()
    scale = 1.0 + max(Xp.abs().max().item(), xbp.abs().max().item())
    assert max((X - Xp).abs().max().item(), (xb - xbp).abs().max().item()) <= 1e-10 * scale
    host = tuple(n(x) for x in chain)
    res = relative_residual(_lanes(host), n(X).transpose(1, 2, 0), n(xb).T, 0)
    res_plain = relative_residual(_lanes(host), n(Xp).transpose(1, 2, 0), n(xbp).T, 0)
    assert res <= max(10 * res_plain, 1e-15)


@pytest.mark.cuda
def test_kernel_dispatch_and_native_on_card():
    """On CUDA tensors the dispatch launches the kernel once per call (a
    vmapped batch included) and native.blocktri_solve* run it."""
    _needs_card()
    assert native_t.available()
    batch = tuple(torch.tensor(x, device="cuda") for x in _batch_major(20, 6, 4, 8, seed=3))
    before = scan_solve_batched.launches
    X, xb = vmap(scan_solve)(*batch)
    X1, xb1 = scan_solve(*(x[1] for x in batch))
    Xn, xbn = native_t.blocktri_solve_batch(*batch)
    assert scan_solve_batched.launches == before + 3
    torch.cuda.synchronize()
    assert torch.equal(X, Xn) and torch.equal(xb, xbn)
    np.testing.assert_allclose(n(X1), n(X[1]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(n(xb1), n(xb[1]), rtol=0, atol=1e-12)
