"""The compiled unbatched solve: the port's counterpart of the JAX package's
`jax.jit(run)` (`ct.solve`, `solve_docp`, the MPC cold start, the
continuations) is the batched IPM at B=1 (solver/ipm.py::batched_ipm), each
segment a CUDA graph (solver/graph.py::BatchGraph), held by the DOCP's
cached solver (solver/interface.py::DOCPSolver).

On the CPU (no card) a solver call is the eager `ipm_solve`. Here: no
segment of the B=1 program makes a capture-illegal call (`CaptureHazards`)
under the cr, the structured, the dense and the f32 + refinement + Ruiz
solves; the persistent-state path (`BatchGraph(capture=False)`, each
segment's outputs copied into persistent tensors as the graphs commit
them) equals `run.eager` bit for bit under "cr" and "dense" in f64, and to
rounding under the structured scan; its result survives the next call and
has the eager result's types and shapes; `debug=True` runs eagerly; the
cold start and the continuations go through the cached solver; one case
against the JAX package's `ct.solve`. On the card (marked `cuda`, skipped
without one; they need no JAX: `python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_solve_graph.py`): the hazard check on
CUDA tensors, the replayed solve against the same program run op by op
bit for bit with equal stats, a second DOCP capturing anew, the counters
under replay, a failing capture raising and dropping the graphs, and
`debug=True` capturing nothing."""

import numpy as np
import pytest
import torch

from torch_helpers import DI, CaptureHazards, n

# the cases: (problem, grid, scheme, options, how the B=1 program compares
# with `run.eager`: "bitwise", or "rounding" (same status and iterations, z
# within 1e-10; the structured scan's reductions run in another order
# under vmap))
CASES = {
    "cartpole_cr": ("cartpole", 12, "trapeze", dict(kkt_mode="cr"), "bitwise"),
    "cartpole_dense": ("cartpole", 12, "trapeze", dict(kkt_mode="dense"), "bitwise"),
    "goddard_cr": ("goddard", 50, "trapeze", dict(kkt_mode="cr"), "bitwise"),
    "double_integrator_structured": (DI, 12, "trapeze", dict(), "rounding"),
    "goddard_structured": ("goddard", 50, "trapeze", dict(kkt_mode="structured"), "rounding"),
    # BASELINE config 2's options on a small grid, stopped early
    "goddard_f32": ("goddard", 20, "gauss_legendre_2_constant_control",
                    dict(kkt_mode="cr", kkt_solve_dtype="f32", mu_strategy="adaptive", max_iter=8), "bitwise"),
}
HAZARD_CASES = ("cartpole_cr", "double_integrator_structured", "cartpole_dense", "goddard_f32")
HAZARD_ITERS = 6


def _run(case, device, **extra):
    """(the DOCP's cached solver, its arguments (z0, zl, zu, cl, cu))."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.interface import _get_solver

    name, grid, scheme, opts, _ = CASES[case]
    prob = get_problem(name)
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme=scheme, device=device)
    run = _get_solver(docp, ct.IPMOptions(**{"tol": 1e-8, **opts, **extra}))
    return run, (docp.initial_guess(prob.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)


def _op_by_op(run, segments=None):
    """A BatchGraph that runs the B=1 program's segments op by op
    (`segments` in place of the program's own, if given)."""
    from ctdirect_tpu_torch.solver.graph import BatchGraph, graph_counters

    return BatchGraph(segments or run.program.segments, graph_counters(run.kkt), run.docp.device, capture=False)


def _hazards(case, device):
    """The B=1 program of a case, its first HAZARD_ITERS iterations, with
    every segment under CaptureHazards; returns the mode."""
    run, args = _run(case, device, max_iter=HAZARD_ITERS)
    mode = CaptureHazards()

    def watched(fn):
        def segment(state):
            with mode:
                return fn(state)

        return segment

    res, _ = run.batched(_op_by_op(run, {k: watched(f) for k, f in run.program.segments.items()}), *args)
    assert res.iterations > 0
    return mode


@pytest.mark.parametrize("case", HAZARD_CASES)
def test_b1_segments_make_no_capture_hazard(case):
    mode = _hazards(case, "cpu")
    assert mode.seen == [], mode.where


def _assert_same(case, got, want):
    """The B=1 program's (IPMResult, postprocess) against the eager solve's,
    as the case says."""
    (res, post), (ref, ref_post) = got, want
    assert (res.status, res.iterations, res.successful) == (ref.status, ref.iterations, ref.successful)
    if CASES[case][-1] == "bitwise":
        for a, b in zip((*res, *post), (*ref, *ref_post)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    else:
        np.testing.assert_allclose(n(res.z), n(ref.z), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", sorted(CASES))
def test_persistent_state_path_equals_eager(case):
    """The solve as a card runs it (set-up loaded into persistent tensors,
    each segment's outputs copied into them), op by op, against
    `run.eager`: bit for bit under "cr" and "dense" in f64 and in the f32
    case's first iterations, to rounding under the structured scan."""
    run, args = _run(case, "cpu")
    _assert_same(case, run.batched(_op_by_op(run), *args), run.eager(*args))
    assert not run.graphed and run.captures == 0


@pytest.mark.parametrize("refine", [0, 2])
def test_b1_program_parts_from_eager_in_the_refinement_residual(refine):
    """Where the B=1 program and `ipm_solve` part under an f32 block solve:
    jackson (trapeze N=50, no Ruiz), one iteration, is bit for bit without
    refinement; with 2 sweeps z agrees to rounding (the f64 residual,
    `_block_matvec`'s einsums, may reduce in another order under vmap)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.interface import _get_solver

    prob = get_problem("jackson")
    docp = ct.transcribe(prob.ocp, grid_size=50, scheme="trapeze", device="cpu")
    run = _get_solver(docp, ct.IPMOptions(tol=1e-6, max_iter=1, kkt_mode="cr", kkt_solve_dtype="f32",
                                          kkt_refine=refine, kkt_equilibrate=False))
    args = (docp.initial_guess(prob.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    diff = (run.batched(_op_by_op(run), *args)[0].z - run.eager(*args)[0].z).abs().max().item()
    assert diff == 0.0 if refine == 0 else diff <= 1e-15


def test_result_survives_the_next_call_with_the_eager_types_and_shapes():
    """Two calls through one set of persistent tensors, the second from
    another x0: the first result is unchanged, and every field has the
    eager result's type, dtype and shape (Python int / int / bool for
    iterations / status / successful)."""
    run, (z0, zl, zu, cl, cu) = _run("double_integrator_structured", "cpu")
    graph = _op_by_op(run)
    first, first_post = run.batched(graph, z0, zl, zu, cl, cu)
    kept = [a.clone() if isinstance(a, torch.Tensor) else a for a in (*first, *first_post)]
    rows = run.docp.boundary_row_indices()[:1]
    cl2, cu2 = cl.copy(), cu.copy()
    cl2[rows] += 1e-2
    cu2[rows] += 1e-2
    second, _ = run.batched(graph, z0, zl, zu, cl2, cu2)
    for a, b in zip((*first, *first_post), kept):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert not torch.equal(second.z, first.z)
    eager, eager_post = run.eager(z0, zl, zu, cl, cu)
    for a, b in zip((*first, *first_post), (*eager, *eager_post)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype, b.device)


def test_cpu_solver_is_eager_and_debug_runs_eagerly(capsys):
    """On the CPU a call is `eager`; with debug=True the solver is never
    graphed (on any device) and prints its per-iteration line."""
    run, args = _run("double_integrator_structured", "cpu")
    for a, b in zip(run(*args)[0], run.eager(*args)[0]):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert not run.graphed and run.captures == 0 and run.graph is None
    capsys.readouterr()
    run, args = _run("double_integrator_structured", "cpu", debug=True)
    res, _ = run(*args)
    assert not run.graphed and run.graph is None
    assert capsys.readouterr().out.count("it=") == res.iterations


def test_cold_start_and_continuations_reach_the_cached_solver(monkeypatch):
    """MPCController.cold_start, continuation and grid_continuation solve
    through DOCPSolver.__call__ (the compiled solve on a card), once per
    DOCP, and drop the solvers of the DOCPs they own."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import MPCController
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver import continuation, grid_continuation
    from ctdirect_tpu_torch.solver.interface import DOCPSolver

    calls = []
    call = DOCPSolver.__call__

    def counted(self, *args):
        calls.append(self.docp)
        return call(self, *args)

    monkeypatch.setattr(DOCPSolver, "__call__", counted)
    p = get_problem(DI)
    docp = ct.transcribe(p.ocp, grid_size=8, scheme="trapeze", device="cpu")
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=1, kkt_algorithm="cr", device="cpu")
    ctrl.cold_start(options=ct.IPMOptions(tol=1e-8, max_iter=30))
    assert calls == [docp] and docp._solver_cache  # the controller's DOCP keeps its solver
    sols = grid_continuation(p.ocp, (8, 12), options=ct.IPMOptions(tol=1e-8), device="cpu")
    assert len(calls) == 3 and all(s.successful for s in sols)
    sols = continuation(lambda v: p.ocp, [0, 1], grid_size=8, options=ct.IPMOptions(tol=1e-8), device="cpu")
    assert len(calls) == 5 and all(s.successful for s in sols)
    assert all("_solver_cache" not in d.__dict__ for d in calls[1:])  # released


def test_released_docp_is_freed_without_the_cycle_collector():
    """A solved DOCP and its cached solver refer to each other; after
    `docp.release_solvers()` dropping the DOCP's last name frees it at once,
    with no cycle collection (and with it, on a card, the solver's graphs
    and pool)."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        run, args = _run("double_integrator_structured", "cpu")
        docp = run.docp
        run.batched(_op_by_op(run), *args)
        del run
        docp.release_solvers()
        alive = weakref.ref(docp)
        del docp
        assert alive() is None
    finally:
        gc.enable()


def test_b1_program_matches_jax_solve():
    """The persistent-state B=1 program of `ct.solve`'s DOCP (double
    integrator, trapeze N=12, default structured solve) against the JAX
    package's `ct.solve`: status, and objective to 1e-8."""
    import ctdirect_tpu as ctj
    from ctdirect_tpu.problems import get_problem as problem_j

    sol_j = ctj.solve(problem_j(DI).ocp, grid_size=12, scheme="trapeze", tol=1e-8)
    run, args = _run("double_integrator_structured", "cpu")
    res, _ = run.batched(_op_by_op(run), *args)
    assert res.status == int(sol_j.status) == 0
    np.testing.assert_allclose(float(res.objective), float(sol_j.objective), rtol=1e-8)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------


@pytest.fixture
def card():
    """The card, with the CR kernel's counts put back after the test as they
    were before it (the kernel's wrapper is one object per process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the solve's graphs and the CR kernel have no CPU mode")
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    counts = kernel.launches, kernel.grid_launches
    yield "cuda"
    kernel.launches, kernel.grid_launches = counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", HAZARD_CASES)
def test_b1_segments_make_no_capture_hazard_on_card(card, case):
    mode = _hazards(case, card)
    assert mode.seen == [], mode.where


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_solve_equals_the_program_op_by_op_on_card(card, case):
    """Two compiled calls (capture, then replay only) and the same B=1
    program run op by op: every field bit for bit, with the same KKT
    solves, host reads and segment runs; the eager solve lands on the same
    status, iterations to within the rounding the case allows, and the
    objective to 1e-8."""
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    run, args = _run(case, card)
    assert run.graphed
    ref = run.batched(_op_by_op(run), *args)
    counts = run.stats
    for _ in range(2):
        run.stats = BatchStats()
        got = run(*args)
        for a, b in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert run.stats == counts
    assert run.captures == len(counts.segments)
    eager, _ = run.eager(*args)
    assert eager.status == got[0].status
    np.testing.assert_allclose(float(got[0].objective), float(eager.objective), rtol=1e-8)


@pytest.mark.cuda
def test_a_second_docp_captures_anew_on_card(card):
    """Each DOCP's solver holds its own graphs; `ct.solve` drops its DOCP's."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    first, args = _run("cartpole_cr", card)
    first(*args)
    second, args2 = _run("cartpole_cr", card)
    assert second is not first and second.graph is None
    second(*args2)
    assert second.captures == first.captures > 0 and second.graph is not first.graph
    sol = ct.solve(get_problem(DI).ocp, grid_size=12, scheme="trapeze", tol=1e-8, kkt_mode="cr", device=card)
    assert sol.successful and sol.infos["kkt_warmup_block_solves"] > 0


@pytest.mark.cuda
def test_counters_grow_by_replays_times_captured_on_card(card):
    """In a first call every segment warms up (its launches real), captures
    (no launch) and replays; the kernel's launches are the block solves plus
    the warm-ups', and `solve_docp` reports the two apart; a second call on
    the same DOCP replays only."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    run, _ = _run("cartpole_cr", card)
    P = 1 << (run.docp.N - 1).bit_length()
    per_solve = len(kernel.plan(P, 1, 0, 1, 8))
    for call in range(2):
        kernel.reset_counts()
        solves0 = run.stats.kkt_solves
        sol = ct.solve_docp(run.docp, init=None, options=run.options)
        blocks, warm = sol.infos["kkt_block_solves"], sol.infos["kkt_warmup_block_solves"]
        assert blocks == run.stats.kkt_solves - solves0
        assert kernel.launches == blocks + warm and kernel.grid_launches == kernel.launches * per_solve
        assert (warm > 0) if call == 0 else (warm == 0)
    solving = ("reg_trial", "soc", "restore", "refresh")  # the segments with a KKT solve
    assert run.warmup_block_solves == sum(s in solving for s in run.graphs)


@pytest.mark.cuda
def test_a_failing_capture_raises_and_drops_the_graphs_on_card(card):
    """A KKT solve that waits for the device inside a segment runs eagerly
    but cannot be captured: the call raises, the solver's graphs are
    dropped, and nothing falls back to the eager solve."""
    run, args = _run("cartpole_cr", card)
    solve = run.kkt.solve

    def syncing(*a):
        torch.cuda.synchronize()
        return solve(*a)

    run.kkt.solve = syncing
    run.eager(*args)
    with pytest.raises(RuntimeError):
        run(*args)
    assert run.graph is None and run.captures == 0


@pytest.mark.cuda
def test_debug_runs_eagerly_on_card(card, capsys):
    run, args = _run("double_integrator_structured", card, debug=True)
    res, _ = run(*args)
    assert not run.graphed and run.captures == 0 and run.graph is None
    assert capsys.readouterr().out.count("it=") == res.iterations


# BASELINE config 2 (Goddard GL2 N=200, f64) with chip_smoke.py phase 10's options
PROFILED = ("goddard", 200, "gauss_legendre_2_constant_control", dict(tol=1e-8, mu_strategy="adaptive", kkt_mode="cr"))
PROFILED_REPLAYS = 5


@pytest.mark.cuda
def test_profiled_replays_see_every_cr_launch_on_card(card, monkeypatch):
    """BASELINE config 2 replayed PROFILED_REPLAYS times under
    torch.profiler (utils.profiling.kernel_events): every profile sees the
    CR kernel's CUDA launches that the replay's block solves plan, a profile
    that lost records to CUPTI is taken again; each reading is printed (run
    with -s), with the records dropped."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.utils.profiling import kernel_events

    monkeypatch.setenv("KINETO_LOG_LEVEL", "2")  # read where kineto first starts in the process
    name, grid, scheme, opts = PROFILED
    prob = get_problem(name)
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme=scheme, device=card)
    run = _get_solver(docp, ct.IPMOptions(**opts))
    args = (docp.initial_guess(prob.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    run(*args)
    per = len(kernel.plan(1 << (docp.N - 1).bit_length(), 1, 0, 1, 8))

    def replay():
        n0 = run.kkt.block_solves
        run(*args)
        return (run.kkt.block_solves - n0) * per

    for k in range(PROFILED_REPLAYS):
        rec = kernel_events(replay)
        print(f"profiled replay {k}: {rec['seen']} CR kernel events seen, planned {rec['want']}; CUPTI dropped "
              f"{rec['dropped']} activity records over {rec['tries']} profiles; wall {rec['wall']:.3f} s")
        assert rec["seen"] == rec["want"] > 0
    docp.release_solvers()
