"""Batched block cyclic reduction, port only (this file imports no JAX, so it
also runs on a machine with a card and no JAX: `python -m pytest --noconftest
tests/test_torch_cr_kernel.py`): the plain `cr_solve_lanes` against a dense
oracle, the `vmap` dispatch rule against per-instance calls and the scan
solve, the kernel wrapper's CPU behaviour, and the CUDA kernel against its
plain version on the card (marked `cuda`, skipped without one)."""

import sys

import numpy as np
import pytest
import torch
from torch.func import vmap

from torch_helpers import dense_lane_system, lane_residuals, n, random_chain_lanes, relative_residual, t

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
    assert cr_solve_batched.grid_launches == 0


def test_wrapper_rejects_other_devices():
    chain = tuple(t(x).to("meta") for x in random_chain_lanes(4, 3, 2, 2))
    with pytest.raises(RuntimeError, match="unsupported device"):
        cr_solve_batched(*chain)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _tie_chain(P, bs, wb, B, seed):
    """A random chain whose every diagonal block has three entries of equal
    magnitude in its first column (rows 0-2): the first pivot is a tie, which
    the kernel must break as the plain version does (the first row)."""
    A, Bp, E, F, r, rb = random_chain_lanes(P, bs, wb, B, seed=seed)
    for i, v in ((1, -4.0), (2, 4.0), (3, 0.5), (4, 0.5)):  # well conditioned (cond ~30)
        A[:, i, 0] = A[:, 0, i] = v
    A[:, 0, 0] = 4.0
    return A, Bp, E, F, r, rb


def _ill_tie_chain(P, bs, wb, B, seed, eps=3e-3):
    """The tie of `_tie_chain` (rows 0-2 of every first column at 4, -4, 4) on
    nearly singular blocks: the diagonal of rows 1 and 2 is set to
    4 + (A_12 + 4)(1 + eps), where the leading 3 x 3 is singular at eps = 0.
    The Schur blocks of the later levels are then ill conditioned, so that
    two f32 solutions of small residual may differ by tens of per cent."""
    A, Bp, E, F, r, rb = random_chain_lanes(P, bs, wb, B, seed=seed)
    for i, v in ((1, -4.0), (2, 4.0)):
        A[:, i, 0] = A[:, 0, i] = v
    A[:, 0, 0] = 4.0
    A[:, 1, 1] = A[:, 2, 2] = 4.0 + (A[:, 1, 2] + 4.0) * (1.0 + eps)
    return A, Bp, E, F, r, rb


def test_plain_cr_on_an_ill_conditioned_tie_chain():
    """On the ill-conditioned tie chain the plain version's f64 solve has a
    rounding-level residual and its f32 solve a small one, but the f32
    solution is more than 10 % off the f64 one on some lane: there, a
    kernel is held to the plain version by its residual, not by agreement
    (the card test below)."""
    chain = _ill_tie_chain(16, 5, 3, 33, seed=4)
    assert np.all(np.abs(chain[0][:, :3, 0]) == 4.0)
    X64, xb64 = lanes.cr_solve_lanes(*(t(x) for x in chain))
    X32, xb32 = lanes.cr_solve_lanes(*(t(x, torch.float32) for x in chain))
    tchain = tuple(t(x) for x in chain)
    assert n(lane_residuals(tchain, X64, xb64)).max() < 1e-12
    assert n(lane_residuals(tchain, X32, xb32)).max() < 2e-4
    err = (X32.double() - X64).abs().amax(dim=(0, 1)) / X64.abs().amax(dim=(0, 1)).clamp(min=1.0)
    assert n(err).max() > 0.1
    assert max(np.linalg.cond(dense_lane_system(chain, lane)[0]) for lane in range(33)) > 1e5


def test_plain_cr_solves_a_pivot_tie_chain():
    """The tie chain is solvable and the plain version solves it (the card
    test holds the kernel against this)."""
    chain = _tie_chain(16, 5, 3, 33, seed=4)
    assert np.all(np.abs(chain[0][:, :3, 0]) == 4.0)
    X, xb = lanes.cr_solve_lanes(*(t(x) for x in chain))
    assert max(relative_residual(chain, X, xb, lane) for lane in (0, 32)) < 1e-13


# (P, bs, wb, B): the paths' shapes, P in {1, 2, 8, 256}, B in {1, 3, 33, 512},
# and widths of every class: 2 bs <= 32 (one column of the inverse per lane) or
# more, bs + wb <= 32 (one root row per lane) or more, up to the cap of 64
CARD_SHAPES = [
    (128, 5, 7, 512),  # the MPC tick
    (16, 12, 8, 130),  # ragged last warp of a transpose tile
    (64, 9, 13, 1024),  # the cart-pole chain (trapeze N=60)
    (1, 3, 2, 3),  # root solve only
    (256, 19, 8, 1),  # goddard GL2 constant control at N=200: the unbatched cr path (B=1)
    (256, 30, 11, 1),  # goddard_all GL3 (width 41), B=1
    (256, 30, 11, 256),  # the same chain batched
    (2, 4, 3, 33),
    (8, 6, 5, 33),
    (8, 1, 0, 3),  # scalar blocks, no border
    (2, 17, 0, 1),  # 34 inverse columns, no border
    (8, 40, 24, 3),  # width 64: 80 inverse columns, 64 root rows
    (1, 20, 44, 1),  # width 64, root only
    (256, 2, 1, 512),
]


def _check_on_card(host, dtype, tol):
    chain = tuple(torch.tensor(x, device="cuda", dtype=dtype) for x in host)
    P, bs, _, B = host[0].shape
    wb = host[2].shape[2]
    before, grid_before = cr_solve_batched.launches, cr_solve_batched.grid_launches
    X, xb = cr_solve_batched(*chain)
    assert cr_solve_batched.launches == before + 1
    itemsize = torch.finfo(dtype).bits // 8
    assert cr_solve_batched.grid_launches == grid_before + len(cr_solve_batched.plan(P, bs, wb, B, itemsize))
    Xp, xbp = lanes.cr_solve_lanes(*chain)
    torch.cuda.synchronize()
    scale = max(1.0, Xp.abs().max().item(), xbp.abs().max().item() if wb else 0.0)
    assert (X - Xp).abs().max().item() <= tol * scale
    if wb:
        assert (xb - xbp).abs().max().item() <= tol * scale
    bound = 2e-4 if dtype == torch.float32 else 1e-12
    assert max(relative_residual(host, X, xb, lane) for lane in (0, B - 1)) < bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("P,bs,wb,B", CARD_SHAPES)
def test_kernel_matches_plain_on_card(P, bs, wb, B, dtype, tol):
    _needs_card()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    host = random_chain_lanes(P, bs, wb, B, seed=P + bs, dtype=np_dtype)
    _check_on_card(host, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_kernel_breaks_pivot_ties_as_plain_on_card(dtype, tol):
    _needs_card()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    host = tuple(x.astype(np_dtype) for x in _tie_chain(16, 5, 3, 33, seed=4))
    _check_on_card(host, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_residual_on_an_ill_conditioned_tie_chain_on_card(dtype):
    """On the ill-conditioned tie chain the kernel's dense residual (every
    lane) stays within 10x of the plain version's on the same card, and at
    rounding level in f64. The solutions are not compared: this chain
    amplifies rounding about 3e6-fold in both types, in the plain version
    as in the kernel (on an H100, 21 % apart in f32 and 3e-10 in f64)."""
    _needs_card()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    host = tuple(x.astype(np_dtype) for x in _ill_tie_chain(16, 5, 3, 33, seed=4))
    chain = tuple(torch.tensor(x, device="cuda") for x in host)
    X, xb = cr_solve_batched(*chain)
    Xp, xbp = lanes.cr_solve_lanes(*chain)
    res, res_plain = lane_residuals(chain, X, xb), lane_residuals(chain, Xp, xbp)
    scale = max(1.0, Xp.abs().max().item(), xbp.abs().max().item())
    err = max((X - Xp).abs().max().item(), (xb - xbp).abs().max().item())
    print(f"ill-conditioned tie chain, {dtype}: dense residual max kernel {res.max().item():.3e}, plain "
          f"{res_plain.max().item():.3e}; max lane ratio {(res / res_plain).max().item():.3g}; max abs "
          f"difference {err:.3e} at a solution scale of {scale:.4g}")
    assert res.max().item() <= 10 * res_plain.max().item()
    if dtype == torch.float64:
        assert res.max().item() < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("P,bs,wb,B", [(1, 3, 2, 3), (2, 4, 3, 33), (256, 19, 8, 1), (128, 5, 7, 512)])
def test_one_solve_is_one_launch_on_card(P, bs, wb, B):
    """One solve call counts one `launches` and the planned CUDA launches
    (3 + 3 log2 P) in `grid_launches`."""
    _needs_card()
    assert len(cr_solve_batched.plan(P, bs, wb, B, 8)) == 3 + 3 * (P.bit_length() - 1)
    chain = tuple(torch.tensor(x, device="cuda") for x in random_chain_lanes(P, bs, wb, B))
    before, grid_before = cr_solve_batched.launches, cr_solve_batched.grid_launches
    cr_solve_batched(*chain)
    torch.cuda.synchronize()
    assert cr_solve_batched.launches == before + 1
    assert cr_solve_batched.grid_launches - grid_before == 3 + 3 * (P.bit_length() - 1)


@pytest.mark.cuda
def test_too_wide_chain_raises_on_card():
    """A CUDA chain wider than the cap raises before any launch; nothing
    falls back to the plain version."""
    _needs_card()
    chain = tuple(torch.tensor(x, device="cuda") for x in random_chain_lanes(2, 40, 25, 2))
    before = (cr_solve_batched.launches, cr_solve_batched.grid_launches)
    with pytest.raises(ValueError, match="bs \\+ wb = 65 exceeds the cap 64"):
        cr_solve_batched(*chain)
    assert (cr_solve_batched.launches, cr_solve_batched.grid_launches) == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("bs,wb", [(5, 7), (9, 13), (19, 8), (30, 11), (40, 24), (64, 0)])
def test_instantiation_by_width(bs, wb):
    """Every width up to the cap of 64 plans (the tick's 12, cart-pole's 22,
    Goddard GL2's 27, goddard_all GL3's 41 and the widest), with each
    block's shared memory inside the card's 227 KB in f32 and f64; the
    library takes no plan for a wider chain."""
    _needs_card()
    for itemsize in (4, 8):
        for B in (1, 256):
            launches = cr_solve_batched.plan(256, bs, wb, B, itemsize)
            assert all(smem <= 232448 for *_, smem in launches)
    with pytest.raises(ValueError, match="takes no plan"):
        cr_solve_batched.plan(8, bs, 65 - bs, 1, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 8, 256])
def test_launch_plan_per_chain_length(P):
    """pack, (up_odd, up_even) per level, root, down per level, unpack: 3 +
    3 log2 P launches, the levels halving their warps on the way up and
    doubling them on the way down (the library's plan)."""
    _needs_card()
    plan = cr_solve_batched.plan(P, 5, 7, 1, 8)
    levels = P.bit_length() - 1
    assert [k for k, *_ in plan] == ["pack"] + ["up_odd", "up_even"] * levels + ["root"] + ["down"] * levels + ["unpack"]
    ups = [blocks for k, blocks, *_ in plan if k == "up_odd"]
    downs = [blocks for k, blocks, *_ in plan if k == "down"]
    assert ups == [P >> (lv + 1) for lv in range(levels)] and downs == ups[::-1]
    with pytest.raises(ValueError, match="takes no plan"):
        cr_solve_batched.plan(3 * P, 5, 7, 1, 8)


@pytest.mark.cuda
def test_workspace_and_shared_sizing():
    """The library's workspace elements and shared bytes per block at the
    paths' shapes, counted by hand; the form's one choice, warps per block,
    follows the warps in the launch (1 below 2,048, else 4) and the shared
    memory."""
    _needs_card()
    cr_solve_batched.library()
    # the tick, f64: A, Bp, saved Bl 3 x 128 x 25; E 128 x 35; r, X 2 x 128 x 5;
    # F 49, rb, xb 2 x 7; 64 records of 25 + 35 + 5 + 49 + 7 = 121
    assert cr_solve_batched._lib.cr_workspace_elems(128, 5, 7, 512) == 512 * (9600 + 4480 + 1280 + 49 + 14 + 64 * 121)
    tick = cr_solve_batched.plan(128, 5, 7, 512, 8)
    # level 1: 64 x 512 warps, 4 per block, (6 x 25 + 2 x 35 + 3 x 5) x 8 B a warp
    assert tick[1] == ("up_odd", 64 * 512 // 4, 128, 4 * 235 * 8)
    assert tick[2] == ("up_even", 64 * 512 // 4, 128, 0)
    # the root at B=512: 512 warps (< 2,048), one per block, (12 x 13 + 12) x 8 B
    assert tick[15] == ("root", 512, 32, 168 * 8)
    goddard = cr_solve_batched.plan(256, 19, 8, 1, 8)
    # B=1: 128 warps at level 1, one per block: (6 x 361 + 2 x 152 + 57) x 8 B
    assert goddard[1] == ("up_odd", 128, 32, 2527 * 8)
    # goddard_all at B=256, f64: 49,200 B a warp, 4 per block fit in 227 KB
    assert cr_solve_batched.plan(256, 30, 11, 256, 8)[1] == ("up_odd", 128 * 256 // 4, 128, 4 * 49200)
    # width 64 at B=256, f64: 198,144 B a warp, so one per block
    assert cr_solve_batched.plan(256, 64, 0, 256, 8)[1] == ("up_odd", 128 * 256, 32, 198144)


def _chain_on(P=8, bs=3, wb=2, B=4, dtype=torch.float64):
    return [t(x, dtype) for x in random_chain_lanes(P, bs, wb, B)]


def _bad_chain(case):
    chain = _chain_on()
    if case == "too wide":
        return [t(x) for x in random_chain_lanes(2, 40, 25, 2)], ValueError, "bs \\+ wb = 65 exceeds the cap 64"
    if case == "not a power of two":
        return [t(x) for x in random_chain_lanes(6, 3, 2, 2)], ValueError, "chain length 6 is not a power of two"
    if case == "float16":
        return [x.half() for x in chain], TypeError, "float32 or float64 only"
    if case == "mixed dtypes":
        chain[3] = chain[3].float()
        return chain, ValueError, "F is torch.float32 on cpu, want torch.float64"
    if case == "wrong shape":
        chain[4] = chain[4][:, :, :3]
        return chain, ValueError, "r has shape \\(8, 3, 3\\), want \\(8, 3, 4\\)"
    chain[1] = chain[1].transpose(1, 2)  # not contiguous
    return chain, ValueError, "Bp is not contiguous"


@pytest.mark.parametrize("case", ["too wide", "not a power of two", "float16", "mixed dtypes", "wrong shape",
                                  "not contiguous"])
def test_chain_checks_reject_before_any_launch(case):
    """What the wrapper checks in Python before a launch on the card (run
    here on CPU tensors): the lane-minor contract, one dtype, contiguity, a
    power-of-two chain, the width cap."""
    chain, err, match = _bad_chain(case)
    with pytest.raises(err, match=match):
        cr_kernel.check_chain(*chain)


@pytest.mark.parametrize("P,bs,wb,B,dtype", [(8, 3, 2, 4, torch.float64), (1, 3, 2, 1, torch.float32),
                                              (2, 4, 0, 3, torch.float64)])
def test_chain_checks_pass_the_contract(P, bs, wb, B, dtype):
    """A chain of the contract passes (one block, no border, either dtype)."""
    assert cr_kernel.check_chain(*_chain_on(P, bs, wb, B, dtype)) == (P, bs, wb, B)


SAMPLE_PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16up_oddIdEEvNS_4WorkIT_EENS_5ShapeEiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16up_oddIdEEvNS_4WorkIT_EENS_5ShapeEiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, 432 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_14downIfEEvNS_4WorkIT_EENS_5ShapeEiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 428 bytes cmem[0]
"""


def test_cached_build_returns_its_ptxas_log(tmp_path, monkeypatch):
    """A build keeps its compiler log beside the library; a library found in
    the build cache comes back with that log, so a second `chip_smoke.py` in
    one checkout still reads ptxas's registers, stack and spills; a cached
    library without its log is built again. The compiler here is a stand-in
    that writes an empty library and prints a ptxas report."""
    import chip_smoke

    build_dir, fake = tmp_path / "build", tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\nopen(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n"
                    f"sys.stderr.write({SAMPLE_PTXAS_LOG!r})\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cr_kernel, "BUILD_DIR", build_dir)
    monkeypatch.setattr(cr_kernel, "_nvcc", lambda: str(fake))
    lib = cr_kernel.artifact(verbose=True)
    assert lib.parent == build_dir and lib != cr_kernel.artifact(verbose=False)
    path, seconds, log = cr_kernel.build(verbose=True)
    assert (path, log) == (lib, SAMPLE_PTXAS_LOG) and seconds > 0.0
    assert sorted(f.name for f in build_dir.iterdir()) == [lib.with_suffix(".log").name, lib.name]
    assert cr_kernel.build(verbose=True) == (lib, 0.0, SAMPLE_PTXAS_LOG)
    rows = chip_smoke.ptxas_report(cr_kernel.build(verbose=True)[2])
    assert rows == [dict(kernel="up_odd<double>", stack=0, spill_stores=0, spill_loads=0, registers=80),
                    dict(kernel="down<float>", stack=0, spill_stores=0, spill_loads=0, registers=48)]
    lib.with_suffix(".log").unlink()

    def no_compiler():
        raise RuntimeError("rebuild")

    monkeypatch.setattr(cr_kernel, "_nvcc", no_compiler)
    with pytest.raises(RuntimeError, match="rebuild"):
        cr_kernel.build(verbose=True)
