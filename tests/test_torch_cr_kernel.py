"""Batched block cyclic reduction, port only (this file imports no JAX, so it
also runs on a machine with a card and no JAX: `python -m pytest --noconftest
tests/test_torch_cr_kernel.py`): the plain `cr_solve_lanes` against a dense
oracle, the `vmap` dispatch rule against per-instance calls and the scan
solve, the kernel wrapper's CPU behaviour, and the CUDA kernel against its
plain version on the card (marked `cuda`, skipped without one)."""

import numpy as np
import pytest
import torch
from torch.func import vmap

from torch_helpers import lane_residuals, n, random_chain_lanes, relative_residual, t

from ctdirect_tpu_torch.solver import cr_kernel, lanes
from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched
from ctdirect_tpu_torch.solver.structured_kkt import _scan_solve


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-13), (np.float32, 2e-4)])
def test_plain_cr_solves_the_system(dtype, bound):
    """Independent oracle: reassemble the dense block-tridiagonal + arrowhead
    system for a few lanes and check the relative residual (after
    tests/test_pallas.py::test_pallas_cr_solves_the_system)."""
    P, bs, wb, B = 16, 4, 3, 9
    chain = random_chain_lanes(P, bs, wb, B, seed=3, dtype=dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    X, xb = lanes.cr_solve_lanes(*(t(x, tdt) for x in chain))
    assert max(relative_residual(chain, X, xb, lane) for lane in (0, 4, B - 1)) < bound


def test_lane_residuals_match_the_dense_oracle():
    """The every-lane block-matvec residual (used on the card, where a dense
    matrix per lane is too big) == the dense one lane by lane, and is large
    for a wrong solution."""
    P, bs, wb, B = 8, 4, 3, 5
    chain = random_chain_lanes(P, bs, wb, B, seed=6)
    tchain = tuple(t(x) for x in chain)
    X, xb = lanes.cr_solve_lanes(*tchain)
    assert n(lane_residuals(tchain, X, xb)).max() < 1e-13
    # away from rounding level the two agree lane by lane
    Xw = X + 1e-3 * t(np.random.default_rng(1).standard_normal(X.shape))
    res = n(lane_residuals(tchain, Xw, xb))
    want = [relative_residual(chain, Xw, xb, lane) for lane in range(B)]
    np.testing.assert_allclose(res, want, rtol=1e-9)
    assert res.min() > 1e-6


def _chain_batch_major(N, bs, wb, B, seed):
    """A random symmetric chain as B single-instance systems (batch first):
    A (B,N,bs,bs), Bc (B,N-1,bs,bs), E (B,N,bs,wb), F (B,wb,wb), r, rb."""
    A, Bp, E, F, r, rb = random_chain_lanes(N, bs, wb, B, seed=seed)
    return tuple(t(np.moveaxis(x, -1, 0)) for x in (A, Bp[: N - 1], E, F, r, rb))


@pytest.mark.parametrize("N", [1, 5, 8])
def test_dispatch_vmap_matches_loop(N):
    """The dispatch's vmap rule (whole batch in one batched CR) == a Python
    loop of unbatched calls, and == the sequential scan solve."""
    batch = _chain_batch_major(N, 4, 3, 6, seed=N)
    X, xb = vmap(lanes.cr_solve)(*batch)
    for b in range(6):
        Xb, xbb = lanes.cr_solve(*(a[b] for a in batch))
        np.testing.assert_allclose(n(X[b]), n(Xb), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(n(xb[b]), n(xbb), rtol=1e-12, atol=1e-12)
        Xs, xbs = _scan_solve(*(a[b] for a in batch))
        np.testing.assert_allclose(n(Xb), n(Xs), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(n(xbb), n(xbs), rtol=1e-10, atol=1e-10)


def test_dispatch_broadcasts_unbatched_operands():
    """A vmap with some operands unbatched (in_dims None) broadcasts them."""
    batch = _chain_batch_major(5, 3, 2, 4, seed=11)
    F0 = batch[3][0]
    X, xb = vmap(lanes.cr_solve, in_dims=(0, 0, 0, None, 0, 0))(*batch[:3], F0, *batch[4:])
    for b in range(4):
        Xb, xbb = lanes.cr_solve(*(a[b] for a in batch[:3]), F0, *(a[b] for a in batch[4:]))
        np.testing.assert_allclose(n(X[b]), n(Xb), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(n(xb[b]), n(xbb), rtol=1e-12, atol=1e-12)


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    chain = tuple(t(x) for x in random_chain_lanes(8, 3, 2, 4))
    before = cr_solve_batched.launches
    X, xb = cr_solve_batched(*chain)
    Xp, xbp = lanes.cr_solve_lanes(*chain)
    assert torch.equal(X, Xp) and torch.equal(xb, xbp)
    vmap(lanes.cr_solve)(*_chain_batch_major(5, 3, 2, 3, seed=1))
    assert cr_solve_batched.launches == before == 0
    assert sum(cr_solve_batched.launches_by_cap.values()) == 0


def test_wrapper_rejects_other_devices():
    chain = tuple(t(x).to("meta") for x in random_chain_lanes(4, 3, 2, 2))
    with pytest.raises(RuntimeError, match="unsupported device"):
        cr_solve_batched(*chain)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize(
    "P,bs,wb,B",
    [
        (128, 5, 7, 512),  # the MPC tick shape (bs + wb <= 16 instantiation)
        (16, 12, 8, 130),  # bs + wb <= 32 instantiation, ragged last block of threads
        (64, 9, 13, 1024),  # the cart-pole chain (trapeze N=60; bs + wb <= 32 instantiation)
        (1, 3, 2, 3),  # root solve only
        (256, 19, 8, 1),  # goddard GL2-constant-control at N=200: the unbatched cr path (B=1)
        (256, 30, 11, 1),  # goddard_all GL3 (width 41): bs + wb <= 48 instantiation, B=1
        (256, 30, 11, 256),  # the same chain batched
    ],
)
def test_kernel_matches_plain_on_card(P, bs, wb, B, dtype, tol):
    _needs_card()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    host = random_chain_lanes(P, bs, wb, B, seed=P + bs, dtype=np_dtype)
    chain = tuple(torch.tensor(x, device="cuda") for x in host)
    before = cr_solve_batched.launches
    cap_before = cr_solve_batched.launches_by_cap[cr_kernel.cap(bs, wb)]
    X, xb = cr_solve_batched(*chain)
    assert cr_solve_batched.launches == before + 1
    assert cr_solve_batched.launches_by_cap[cr_kernel.cap(bs, wb)] == cap_before + 1
    Xp, xbp = lanes.cr_solve_lanes(*chain)
    torch.cuda.synchronize()
    scale = max(1.0, Xp.abs().max().item(), xbp.abs().max().item())
    assert (X - Xp).abs().max().item() <= tol * scale
    assert (xb - xbp).abs().max().item() <= tol * scale
    bound = 2e-4 if dtype == torch.float32 else 1e-12
    assert max(relative_residual(host, X, xb, lane) for lane in (0, B - 1)) < bound


@pytest.mark.cuda
def test_dispatch_launches_the_kernel_on_card():
    """Under vmap on CUDA tensors the dispatch launches the kernel once and
    agrees with the plain version on the CPU."""
    _needs_card()
    batch = _chain_batch_major(13, 4, 3, 6, seed=2)
    before = cr_solve_batched.launches
    X, xb = vmap(lanes.cr_solve)(*(a.cuda() for a in batch))
    assert cr_solve_batched.launches == before + 1
    Xc, xbc = vmap(lanes.cr_solve)(*batch)
    np.testing.assert_allclose(n(X), n(Xc), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(n(xb), n(xbc), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize(
    "bs,wb,want", [(5, 7, 16), (8, 8, 16), (9, 13, 32), (20, 12, 32), (19, 14, 48), (30, 11, 48)]
)
def test_instantiation_by_width(bs, wb, want):
    """The tick's chain (bs+wb=12) runs the CAP=16 kernel, cart-pole's (22) the
    CAP=32 one, goddard_all GL3's (41) the CAP=48 one; wider chains raise
    before any launch, naming the width."""
    assert cr_kernel.cap(bs, wb) == want
    with pytest.raises(ValueError, match="bs \\+ wb = 49 exceeds the cap 48"):
        cr_kernel.cap(bs, 49 - bs)
