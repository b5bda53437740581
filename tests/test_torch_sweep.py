"""The suite ladder (ctdirect_tpu_torch/sweep.py, the port of
benchmarks/sweep.py and benchmarks/ladder_report.py's table).

On the CPU: the port's copies of the sweep's data equal the reference's;
the port's run_sweep matches the JAX package's run_sweep cell by cell at
N=40 (f64: status and iterations equal, objectives within 1e-10; f32: ok
equal, objectives within 1e-6); the functions --micro times equal the JAX
DOCP's at the initial guess; a cell run in a process of its own
(--isolate) gives the in-process row; a cell that raises is recorded and
the sweep goes on, with a non-zero exit; the ladder's totals and ratios;
the idle split by segment on a made-up profile; a model of the kernel's
pivot swap equals the plain version's one-hot swap bit for bit; and the
plain CR, like the JAX package's, returns a non-finite solve for a block
that holds an inf, which a CR whose pivot rows are exchanged exactly (the
kernel's fault the ladder found) does not. The `cuda`-marked tests run goddard_all at N=5000
(refine 3, a chain of P=8,192 blocks) and hold the kernel to its plain
version on that block, on a card (no JAX needed: `python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_sweep.py`)."""

import importlib.util
import json
import pathlib
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from ctdirect_tpu_torch import sweep
from torch_helpers import random_chain_lanes

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 40
# the deterministic fields of a row (walls, captures and memory vary)
SAME = ("problem", "N", "ok", "status", "iters", "obj", "ref", "options", "P", "bs", "wb")


def load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_sweep():
    return load(ROOT / "benchmarks" / "sweep.py")


def test_data_equals_the_reference(ref_sweep):
    report = load(ROOT / "benchmarks" / "ladder_report.py")
    assert list(sweep.SUITE) == ref_sweep.EASY_SET
    assert sweep.SUITE_OVERRIDES == ref_sweep.PROBLEM_OVERRIDES
    # the per-cell override of benchmarks/sweep.py:69-73 (a comment there: --refine 3); the
    # table's other entries are the reference's behaviours (ROADMAP.md queue 3)
    assert sweep.CELL_OVERRIDES[("goddard_all", 5000)] == dict(kkt_refine=3)
    assert "goddard_all N=5000" in pathlib.Path(ref_sweep.__file__).read_text()
    assert sweep.REFERENCE == report.REFERENCE
    assert sweep.LADDER == (250, 500, 1000, 2500, 5000)
    large = json.loads((ROOT / "LARGE_N_r05.json").read_text())
    assert list(sweep.LARGE_CELLS) == [(r["problem"], r["N"]) for r in large]
    # every IPMOptions field the sweep's CLI sets, at its defaults
    from ctdirect_tpu_torch import IPMOptions

    pinned = IPMOptions(**sweep.SUITE_OPTS)
    assert (pinned.tol, pinned.max_iter, pinned.kkt_mode, pinned.kkt_solve_dtype) == (1e-6, 500, "cr", "f32")
    assert pinned == IPMOptions(tol=1e-6, max_iter=500, kkt_mode="cr", kkt_solve_dtype="f32")
    # one copy: chip_smoke.py reads the sweep's suite and keeps no options or objectives of its own
    smoke = load(ROOT / "chip_smoke.py")
    assert smoke.SUITE is sweep.SUITE
    for name in ("SUITE_OPTS", "SUITE_OVERRIDES", "SUITE_JAX_CPU", "SUITE_JAX_RTOL"):
        assert not hasattr(smoke, name), name


def test_cell_options_order():
    assert sweep.cell_options("beam", 250) == sweep.SUITE_OPTS
    assert sweep.cell_options("goddard", 500)["mu_strategy"] == "adaptive"
    assert sweep.cell_options("jackson", 250) == dict(sweep.SUITE_OPTS, mu_strategy="adaptive", kkt_equilibrate=False)
    assert sweep.cell_options("goddard_all", 5000)["kkt_refine"] == 3
    assert sweep.cell_options("goddard_all", 2500)["kkt_refine"] == 2
    assert sweep.cell_options("beam", 2500)["kkt_solve_dtype"] is None
    assert sweep.cell_options("beam", 5000)["kkt_solve_dtype"] == "f32"
    assert sweep.jax_rtol("goddard", 500) == sweep.SUITE_JAX_RTOL_DEFAULT == 1e-6
    assert sweep.jax_rtol("goddard", 2500) == 1e-4 and sweep.jax_rtol("jackson", 250) == 1e-5
    f64 = sweep.cell_options("beam", 250, solve_dtype="f64", refine=4, tol=1e-8, max_iter=9)
    assert (f64["kkt_solve_dtype"], f64["kkt_refine"], f64["tol"], f64["max_iter"]) == (None, 4, 1e-8, 9)
    assert sweep.ladder(("a", "b"), (1, 2)) == [("a", 1), ("b", 1), ("a", 2), ("b", 2)]
    assert [sweep.chain_blocks(n) for n in (250, 5000, 10000)] == [256, 8192, 16384]


def _jax_rows(ref_sweep, monkeypatch, problems, solve_dtype):
    """The JAX run_sweep's rows, each with the status of its solve (which
    the reference's row leaves out)."""
    import ctdirect_tpu.solver.interface as jif

    statuses, solve = [], jif.solve_docp

    def recording(*a, **kw):
        sol = solve(*a, **kw)
        statuses.append(int(sol.status))
        return sol

    monkeypatch.setattr(jif, "solve_docp", recording)
    rows = ref_sweep.run_sweep(list(problems), [N], "trapeze", 1e-6, 500, "cr", solve_dtype=solve_dtype)
    for row, status in zip(rows, statuses):
        row["status"] = status
    return rows


@pytest.mark.parametrize("problem,solve_dtype", [
    ("double_integrator_minenergy", "f64"),
    ("beam", "f64"),
    pytest.param("goddard", "f64", marks=pytest.mark.slow),
    pytest.param("fuller", "f32", marks=pytest.mark.slow),
])
def test_run_sweep_matches_jax(ref_sweep, monkeypatch, problem, solve_dtype):
    """One cell of each package's run_sweep on the CPU at N=40 (goddard
    with its adaptive-mu override): f64 block solves agree in ok, status
    and iterations with objectives within 1e-10; an f32 block solve with
    refinement rounds differently, so ok equal and objectives within
    1e-6."""
    (want,) = _jax_rows(ref_sweep, monkeypatch, [problem], solve_dtype)
    (got,) = sweep.run_sweep([(problem, N)], device="cpu", solve_dtype=solve_dtype)
    assert got["failed"] == [] and got["first"] == got["replay"]
    assert got["ok"] == want["ok"], (got, want)
    rel = abs(got["obj"] - want["obj"]) / abs(want["obj"])
    if solve_dtype == "f64":
        assert (got["status"], got["iters"]) == (want["status"], want["iters"])
        assert rel <= 1e-10, rel
    else:
        assert rel <= 1e-6, rel


@pytest.mark.parametrize("problem", ["goddard", "beam"])
def test_micro_functions_match_jax(problem):
    """What --micro times, at the initial guess: the objective, the
    constraints and the gradient of the NLP objective equal the JAX
    DOCP's."""
    import jax

    import ctdirect_tpu as ctj
    from ctdirect_tpu.problems import get_problem as get_j

    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    p, pj = get_problem(problem), get_j(problem)
    z0, fns = sweep.micro_functions(ct.transcribe(p.ocp, grid_size=N, scheme="trapeze", device="cpu"), p.init)
    dj = ctj.transcribe(pj.ocp, grid_size=N, scheme="trapeze")
    zj = np.asarray(dj.initial_guess(pj.init))
    np.testing.assert_array_equal(z0.numpy(), zj)
    want = {"objective": dj.objective(zj), "constraints": dj.constraints(zj),
            "gradient": jax.grad(dj.nlp_objective)(zj)}
    for label, fn in fns.items():
        got, ref = fn(z0).numpy(), np.asarray(want[label])
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * max(1.0, np.abs(ref).max()), err_msg=label)


def test_isolated_cell_gives_the_in_process_row():
    cell = [("double_integrator_minenergy", 20)]
    (alone,) = sweep.run_isolated(cell, ["--cpu"])
    (here,) = sweep.run_sweep(cell, device="cpu")
    assert {k: alone[k] for k in SAME} == {k: here[k] for k in SAME}
    for call in ("first", "replay"):
        assert alone[call] == here[call]
    assert alone["failed"] == here["failed"] == []


def test_a_raising_cell_is_recorded_and_the_sweep_goes_on(tmp_path):
    out = tmp_path / "rows.json"
    rc = sweep.main(["--cpu", "--grids", "20", "--problems", "no_such_problem,double_integrator_minenergy",
                     "--json", str(out)])
    assert rc != 0
    bad, good = json.loads(out.read_text())["rows"]
    assert (bad["problem"], bad["ok"]) == ("no_such_problem", False) and "KeyError" in bad["error"]
    assert (good["problem"], good["ok"], good["failed"]) == ("double_integrator_minenergy", True, [])


def test_without_a_card_the_sweep_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweep.main(["--grids", "20", "--problems", "beam"]) != 0


def test_report_totals_and_ratios():
    def row(name, N, first, replay, ok=True, failed=()):
        return dict(problem=name, N=N, ok=ok, first_s=first, replay_s=replay, failed=list(failed))

    rows = [row("a", 250, 1.0, 0.25), row("b", 250, 2.0, 0.5), row("a", 500, 3.0, 0.7, ok=False),
            row("b", 500, 4.0, 0.7, failed=["the replay differs"]), row("a", 10000, 5.0, 2.0),
            row("beam", 2500, 1.0, 0.5)]
    lines = []
    out = sweep.report(rows, log=lines.append)
    r250, r500, r2500, r10k = out["rungs"]
    assert (r250["green"], r250["cells"], r250["first_s"], r250["replay_s"], r250["ipopt_s"]) == (2, 2, 3.0, 0.75, 0.6)
    assert r250["first_ratio"] == pytest.approx(5.0) and r250["replay_ratio"] == pytest.approx(1.25)
    assert (r500["green"], r500["first_s"], r500["replay_s"]) == (0, 7.0, 1.4)
    assert r500["first_ratio"] == pytest.approx(5.0) and r500["replay_ratio"] == pytest.approx(1.0)
    assert r10k["ipopt_s"] is None and r10k["first_ratio"] is None
    # a rung names its cells that ran under a cell override (beam's f64 block solve at N=2500)
    assert r2500["overrides"] == {"beam": dict(kkt_solve_dtype=None)} and r250["overrides"] == {}
    assert any("beam {'kkt_solve_dtype': None}" in line for line in lines)
    assert out["ok"] is False and out["bad"] == [("a", 500), ("b", 500)]
    assert sweep.report(rows[:2], log=lines.append)["ok"] is True


def test_segment_split_on_a_made_up_profile():
    """Two segment windows (a: 100-200 ns, b: 200-260 ns, its range ends at
    260), device events at 50-120 and 150-230 ns, the profile from 0 to
    300 ns: set-up 0-100 (busy 50), a 100-200 (busy 70), b 200-260 (busy
    30), epilogue 260-300 (busy 0)."""
    from ctdirect_tpu_torch.utils import profiling

    def ev(name, start, dur, device):
        return NS(name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
                  device_type=lambda: NS(name=device), is_user_annotation=lambda: False)

    events = [ev("step", 0, 300, "CPU"), ev(profiling.SEGMENT + "a", 100, 30, "CPU"),
              ev(profiling.SEGMENT + "b", 200, 60, "CPU"), ev("k1", 50, 70, "CUDA"), ev("k2", 150, 80, "CUDA"),
              ev(profiling.STAGE + "x", 150, 10, "CUDA")]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    split = profiling.segment_split(prof)
    assert list(split) == ["set-up", "a", "b", "epilogue"]
    want = {"set-up": (0, 100, 50), "a": (1, 100, 70), "b": (1, 60, 30), "epilogue": (0, 40, 0)}
    for name, (runs, window, busy) in want.items():
        got = split[name]
        assert got["runs"] == runs
        assert got["window_s"] == pytest.approx(window / 1e9) and got["busy_s"] == pytest.approx(busy / 1e9)
        assert got["idle_s"] == pytest.approx((window - busy) / 1e9)


def _chain_with_an_overflowed_block(dtype=np.float64):
    """The tests' random chain (P=16, bs=4, wb=3, 4 lanes) with an inf pair
    in one diagonal block of lane 1, as an f32 block that overflowed holds
    it."""
    A, Bp, E, F, r, rb = random_chain_lanes(16, 4, 3, 4, seed=5, dtype=dtype)
    A[5, 1, 2, 1] = A[5, 2, 1, 1] = np.inf
    return A, Bp, E, F, r, rb


def _exact_exchange_gj(M, n):
    """solver/lanes.py's _gj_eliminate_lanes with rows j and p exchanged
    exactly: the pivoting the CUDA kernel did before it followed its plain
    version's swap (M + onehot * (row_j - row_p))."""
    rsel = torch.arange(n).reshape((1,) * (M.ndim - 3) + (n, 1))
    for j in range(n):
        is_j = (rsel == j)[..., None]
        colj = torch.where(rsel >= j, torch.abs(M[..., :, j, :]), -torch.inf)
        p = torch.argmax(colj, dim=-2)
        is_p = (p[..., None, :] == rsel)[..., None, :]
        rowp = torch.take_along_dim(M, p[..., None, None, :], dim=-3)
        M = torch.where(is_j, rowp, torch.where(is_p, M[..., j:j + 1, :, :], M))
        row = M[..., j, :, :] / M[..., j, j, :][..., None, :]
        colv = torch.where(rsel == j, 0.0, M[..., :, j, :])
        M = torch.where(is_j, row[..., None, :, :], M - colv[..., :, None, :] * row[..., None, :, :])
    return M


def _kernel_gj_steps(M, n, exact):
    """csrc/cr_solve.cu::gj_steps, lane by lane: solver/lanes.py's
    _gj_eliminate_lanes with rows j and p swapped as the kernel swaps them.
    exact: rp = row p, NaN in a column where another row is not finite; d =
    row j - rp; row p += d; row j = rp; the other rows NaN in a column where
    d is not finite. Else the swap for finite data: rp = row p, d = row j -
    rp, row p += d, row j = rp."""
    rsel = torch.arange(n).reshape((1,) * (M.ndim - 3) + (n, 1))
    for j in range(n):
        is_j = (rsel == j)[..., None]
        colj = torch.where(rsel >= j, torch.abs(M[..., :, j, :]), -torch.inf)
        p = torch.argmax(colj, dim=-2)
        is_p = (p[..., None, :] == rsel)[..., None, :]
        rp = torch.take_along_dim(M, p[..., None, None, :], dim=-3)
        d = M[..., j:j + 1, :, :] - rp
        if exact:
            other_bad = (~torch.isfinite(M) & ~is_p).any(dim=-3, keepdim=True)
            rp = torch.where(other_bad, torch.nan, rp)
            d = M[..., j:j + 1, :, :] - rp
            M = torch.where(~torch.isfinite(d) & ~is_p & ~is_j, torch.nan, M)
        M = torch.where(is_j, rp, torch.where(is_p, M + d, M))
        row = M[..., j, :, :] / M[..., j, j, :][..., None, :]
        colv = torch.where(rsel == j, 0.0, M[..., :, j, :])
        M = torch.where(is_j, row[..., None, :, :], M - colv[..., :, None, :] * row[..., None, :, :])
    return M


def _kernel_swap_gj(M, n):
    """csrc/cr_solve.cu::warp_gj: the steps with the finite swap, and where
    their result holds a non-finite entry, the exact steps from the same
    matrix."""
    fast = _kernel_gj_steps(M, n, exact=False)
    bad = (~torch.isfinite(fast)).any(dim=-3, keepdim=True).any(dim=-2, keepdim=True)
    return torch.where(bad, _kernel_gj_steps(M, n, exact=True), fast)


@pytest.mark.parametrize("case", ["finite", "inf", "nan", "overflow"])
def test_the_kernels_swap_equals_the_plain_one_hot_swap(case):
    """The kernel's Gauss-Jordan (a swap for finite data, rerun with the
    exact non-finite rule where its result is not finite) gives bit for bit
    the plain version's one-hot swap, its rounding of row p and its NaNs
    included, over blocks that pivot in every column, hold an inf or a NaN,
    or overflow during the elimination."""
    from ctdirect_tpu_torch.solver import lanes

    rng = np.random.default_rng(11)
    n, k, B = 7, 3, 64
    M = torch.tensor(rng.standard_normal((5, n, n + k, B)) * 10.0 ** rng.integers(-3, 4, (5, n, 1, B)))
    if case in ("inf", "nan"):
        bad = np.inf if case == "inf" else np.nan
        M[1, 3, 2, ::3] = bad
        M[2, 0, n + 1, 1::4] = -bad
        M[3, 5, 0, 2::5] = bad
    elif case == "overflow":
        M[4, 2, :, ::2] *= 1e150
        M[4, :, 5, ::2] *= 1e150
        assert torch.isfinite(M).all()
    want = lanes._gj_eliminate_lanes(M, n)
    got = _kernel_swap_gj(M, n)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    if case != "finite":
        assert not torch.isfinite(want).all()


def test_a_non_finite_block_gives_a_non_finite_solve(monkeypatch):
    """The plain CR (the kernel's specification) and the JAX package's lanes
    CR both return a non-finite solution for the lane whose block holds an
    inf (the reference's pivot swap, M + onehot * (row_j - row_p), carries
    it into every row as 0 * inf), which the IPM rejects as a failed
    trial; the other lanes are untouched. A CR that exchanges the pivot
    rows exactly, as the CUDA kernel did, returns finite values for that
    lane, which the IPM takes for a step: on the card that moved jackson
    at N=2500 from 44 iterations to 500 (PERF.md)."""
    from ctdirect_tpu.solver import lanes as lanes_j

    from ctdirect_tpu_torch.solver import lanes

    chain = _chain_with_an_overflowed_block()
    X, xb = lanes.cr_solve_lanes(*(torch.tensor(x) for x in chain))
    Xj, xbj = (np.asarray(x) for x in lanes_j.cr_solve_lanes(*chain))
    for got, want in ((X.numpy(), Xj), (xb.numpy(), xbj)):
        assert not np.isfinite(got[..., 1]).any() and not np.isfinite(want[..., 1]).any()
        np.testing.assert_allclose(got[..., [0, 2, 3]], want[..., [0, 2, 3]], rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(lanes, "_gj_eliminate_lanes", _exact_exchange_gj)
    Xe, xbe = lanes.cr_solve_lanes(*(torch.tensor(x) for x in chain))
    assert torch.isfinite(Xe).all() and torch.isfinite(xbe).all()
    torch.testing.assert_close(Xe[..., [0, 2, 3]], X[..., [0, 2, 3]], rtol=1e-12, atol=1e-12)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compiled solve's graphs and the CR kernel have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_goddard_all_5000_on_card(card):
    """goddard_all at N=5000 with its per-cell refine 3 (a chain of P=8,192
    blocks): ok, the replay equal to the first call, each call's CR
    launches its block solves plus their warm-ups, the profiled replay at
    its planned launches."""
    opts = sweep.cell_options("goddard_all", 5000)
    assert opts["kkt_refine"] == 3
    row = sweep.run_cell("goddard_all", 5000, opts, device=card, profile=True)
    sweep.print_row(row)
    assert row["ok"] and row["failed"] == [], row
    assert row["P"] == 8192 and row["replay"]["warmup_block_solves"] == 0
    assert row["first"]["cr_launches"] == row["first"]["block_solves"] + row["first"]["warmup_block_solves"]
    assert row["replay"]["cr_launches"] == row["replay"]["block_solves"] > 0
    assert row["profile"]["cr_launches"] == row["replay"]["block_solves"] * (3 + 3 * 13)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_fails_as_its_plain_version_on_a_non_finite_block(card, dtype):
    """The kernel's solution is non-finite exactly where its plain version's
    is (lane 1, whose block holds an inf) and agrees elsewhere; before its
    pivot swap followed the plain version's, it returned finite values."""
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched
    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes

    chain = tuple(torch.tensor(x, dtype=dtype, device=card) for x in _chain_with_an_overflowed_block())
    got, want = cr_solve_batched(*chain), cr_solve_lanes(*chain)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for g, w in zip(got, want):
        assert torch.equal(torch.isfinite(g), torch.isfinite(w)) and not torch.isfinite(g[..., 1]).any()
        torch.testing.assert_close(g[..., [0, 2, 3]], w[..., [0, 2, 3]], rtol=tol, atol=tol)
