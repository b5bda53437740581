"""The compiled batched solve: the port's counterpart of `jax.jit(vsolve)` is
the batched IPM split at its host reads into ten segments
(solver/ipm.py::batched_ipm), each captured as a CUDA graph and replayed
(parallel/batch.py::BatchGraph).

On the CPU (no card): every segment of every case makes no capture-illegal
call (`CaptureHazards`), and the cases together run every segment; the
persistent-state path (each segment's outputs copied into the solver's
persistent tensors, as the graphs commit them) equals the eager solve bit
for bit; a CPU solver runs the eager solve and captures nothing; the
segmented solve, through the branches the cases force (SOC, restoration,
dual refresh), equals the JAX package's BatchSolver. On the card (marked
`cuda`, skipped without one; the card tests need no JAX: `python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_batch_graph.py`): the same
hazard check on CUDA tensors, the graphed solve against the eager one bit
for bit, what a call returns after the next one, one set of graphs per
batch size, the counters under replay, and a capture that fails raising."""

import pytest
import torch

from torch_helpers import BATCH, DI, CaptureHazards, batch_inputs, check_batch_solver_matches_jax

BOX = [1.0, 0.8, 1.25]  # the control box of each instance, scaled
# the cases: (problem, grid, options, control box scales, the segments it
# must run; "reg_trial+" is the regularization ladder past its trial 0).
# max_ls=0 turns every rejected first trial without a valid SOC into a
# restoration; recalc_lam_alpha=1 asks for the dual refresh after every
# nearly feasible accepted step; max_iter stops each case soon after the
# last segment it needs first runs.
CASES = {
    "cartpole": ("cartpole", 8, dict(max_iter=4), BOX, {"reg_trial+", "soc", "bt_trial"}),
    "cartpole_restore_refresh": ("cartpole", 8, dict(max_iter=8, max_ls=0, recalc_lam_alpha=1.0), BOX,
                                 {"reg_trial+", "soc", "restore", "refresh"}),
    "double_integrator_structured": (DI, 8, dict(kkt_mode="structured", recalc_lam_alpha=1.0), None,
                                     {"refresh"}),
    "double_integrator_f32": (DI, 8, dict(kkt_solve_dtype="f32", recalc_lam_alpha=1.0), None, {"refresh"}),
}


def _solver(case, device, **kw):
    """(solver, inputs (z0, cl, cu, zl, zu), the segments the case must run)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.problems import get_problem

    name, grid, opts, box, wants = CASES[case]
    prob = get_problem(name)
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme="trapeze", device=device)
    options = ct.IPMOptions(**{"tol": 1e-8, "kkt_mode": "cr", **opts})
    inputs = tuple(docp.tensor(a) for a in batch_inputs(docp, prob.init, seed=1, box_scale=box))
    return BatchSolver(docp, options, device=device, **kw), inputs, wants


def _ran(stats):
    """The segments a solve ran, "reg_trial+" when the ladder went past trial 0."""
    ran = set(stats.segments)
    if stats.segments.get("reg_trial", 0) > stats.segments.get("prologue", 0):
        ran.add("reg_trial+")
    return ran


def _hazards(case, device):
    """Runs a case's eager solve with every segment under CaptureHazards;
    returns the mode and the segments that ran (the solve under the mode is
    also bit for bit the solve without it)."""
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    solver, (z0, cl, cu, zl, zu), wants = _solver(case, device)
    prog, stats, mode = solver.program, BatchStats(), CaptureHazards()
    state = prog.setup(z0, zl, zu, cl, cu, stats)

    def run(name):
        with mode:
            out = prog.segments[name](state)
        state.update(out)

    prog.drive(state, run, stats)
    for a, b in zip(prog.epilogue(state), solver.eager(z0, cl, cu, zl, zu)):
        assert torch.equal(a, b)
    assert _ran(stats) >= wants, (wants, stats.segments)
    return mode


@pytest.mark.parametrize("case", sorted(CASES))
def test_segments_make_no_capture_hazard(case):
    mode = _hazards(case, "cpu")
    assert mode.seen == [], mode.where


def test_cases_run_every_segment():
    """The cases' segments together (each case checks its own in the test
    above) are every segment, the ladder past its trial 0 included."""
    from ctdirect_tpu_torch.solver.ipm import SEGMENTS

    always = {"prologue", "reg_trial", "ls_setup", "select", "clamp", "close"}
    assert always | set().union(*(c[-1] for c in CASES.values())) == set(SEGMENTS) | {"reg_trial+"}


def _persistent_path(solver, inputs):
    """The solve as `BatchSolver` runs it on a card, with the segments run op
    by op instead of replayed (BatchGraph(capture=False)): set-up loaded
    into persistent tensors, each segment's outputs copied into them."""
    from ctdirect_tpu_torch.parallel.batch import BatchGraph

    z0, cl, cu, zl, zu = inputs
    prog = solver.program
    graph = solver.graphs.get(z0.shape[0])
    if graph is None:
        graph = solver.graphs[z0.shape[0]] = BatchGraph(prog.segments, solver._counters, "cpu", capture=False)
    graph.load(prog.setup(z0, zl, zu, cl, cu, solver.stats))
    prog.drive(graph.state, graph.run, solver.stats)
    return [x.clone() for x in prog.epilogue(graph.state)]


@pytest.mark.parametrize("case", ["cartpole", "cartpole_restore_refresh"])
def test_persistent_state_path_equals_eager(case):
    """Two calls (the second from other inputs, into the same persistent
    tensors): results, KKT solves, host reads and segment runs equal the
    eager solve's, bit for bit."""
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    solver, inputs, _ = _solver(case, "cpu")
    other = (inputs[0],) + tuple(a.clone() for a in inputs[1:])
    other[1][:, 0] += 1e-3
    other[2][:, 0] += 1e-3
    for args in (inputs, other):
        solver.stats = BatchStats()
        committed = _persistent_path(solver, args)
        counts = solver.stats
        solver.stats = BatchStats()
        for a, b in zip(committed, solver.eager(*args)):
            assert torch.equal(a, b)
        assert counts == solver.stats
    assert len(solver.graphs) == 1


def test_cpu_solver_runs_the_eager_solve():
    """On the CPU `__call__` is the eager solve: nothing captured, the same
    results as `eager` bit for bit."""
    solver, (z0, cl, cu, zl, zu), _ = _solver("double_integrator_f32", "cpu")
    for a, b in zip(solver(z0, cl, cu, zl, zu), solver.eager(z0, cl, cu, zl, zu)):
        assert torch.equal(a, b)
    assert not solver.graphed and solver.captures == 0 and solver.graphs == {}


def test_segmented_solve_through_restoration_and_refresh_matches_jax():
    """The cart-pole batch of tests/test_torch_batch.py with restoration and
    the dual refresh forced (max_ls=0: 3 restorations; recalc_lam_alpha=1:
    18 refreshes) against the JAX BatchSolver, at that test's tolerance."""
    pytest.importorskip("jax")
    check_batch_solver_matches_jax("cartpole", max_ls=0, recalc_lam_alpha=1.0)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------


@pytest.fixture
def card():
    """The card, with the CR kernel's counts put back after the test as they
    were before it (the kernel's wrapper is one object per process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the batch's graphs and the CR kernel have no CPU mode")
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    counts = kernel.launches, kernel.grid_launches
    yield "cuda"
    kernel.launches, kernel.grid_launches = counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_segments_make_no_capture_hazard_on_card(card, case):
    mode = _hazards(case, card)
    assert mode.seen == [], mode.where


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_solve_equals_eager_on_card(card, case):
    """Two graphed calls (capture, then replay only) and the eager solve of
    the same inputs: every field bit for bit, and the same KKT solves, host
    reads and segment runs."""
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    solver, (z0, cl, cu, zl, zu), wants = _solver(case, card)
    eager = solver.eager(z0, cl, cu, zl, zu)
    counts = solver.stats
    for _ in range(2):
        solver.stats = BatchStats()
        for a, b in zip(solver(z0, cl, cu, zl, zu), eager):
            assert a.shape == b.shape and torch.equal(a, b)
        assert solver.stats == counts
    assert _ran(counts) >= wants
    assert solver.captures == len(counts.segments) and len(solver.graphs) == 1


@pytest.mark.cuda
def test_returned_tensors_survive_the_next_call_on_card(card):
    solver, (z0, cl, cu, zl, zu), _ = _solver("cartpole", card)
    first = solver(z0, cl, cu, zl, zu)
    kept = [a.clone() for a in first]
    second = solver(z0, cl + 1e-3, cu + 1e-3, zl, zu)
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert not torch.equal(second.z, first.z)  # the replay saw the new inputs
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(first, second))


@pytest.mark.cuda
def test_a_new_batch_size_captures_again_on_card(card):
    solver, (z0, cl, cu, zl, zu), _ = _solver("double_integrator_f32", card)
    captures = []
    for rows, sizes in ((BATCH, 1), (BATCH - 1, 2), (BATCH, 2), (BATCH - 1, 2)):
        res = solver(z0[:rows], cl[:rows], cu[:rows], zl[:rows], zu[:rows])
        assert res.z.shape == (rows, z0.shape[1]) and len(solver.graphs) == sizes
        captures.append(solver.captures)
    assert 0 < captures[0] < captures[1] == captures[2] == captures[3]
    assert set(solver.graphs) == {BATCH, BATCH - 1}


@pytest.mark.cuda
def test_counters_grow_by_replays_times_captured_on_card(card):
    """A segment's first use warms up (its launches real, in `warmup_added`),
    captures (no launch) and replays; each replay adds what the capture
    added: one kernel launch per KKT solve, 3 + 3 log2 P CUDA launches each."""
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    solver, (z0, cl, cu, zl, zu), _ = _solver("cartpole", card)
    P = 1 << (solver.docp.N - 1).bit_length()
    per_solve = len(kernel.plan(P, 1, 0, 1, 8))
    for call in range(3):
        kernel.reset_counts()
        solves0, blocks0 = solver.stats.kkt_solves, solver.kkt.block_solves
        solver(z0, cl, cu, zl, zu)
        graph = solver.graphs[BATCH]
        warm = graph.warmup_added[kernel, "launches"] if call == 0 else 0
        assert kernel.launches == solver.stats.kkt_solves - solves0 + warm
        assert kernel.grid_launches == kernel.launches * per_solve
        assert solver.kkt.block_solves - blocks0 == kernel.launches
    solving = ("reg_trial", "soc", "restore", "refresh")  # the segments with a KKT solve
    assert graph.warmup_added[kernel, "launches"] == sum(s in solving for s in graph.graphs)


@pytest.mark.cuda
def test_a_failing_capture_raises_on_card(card):
    """A KKT operator that waits for the device inside a segment runs eagerly
    but cannot be captured: the call raises, the batch size's graphs are
    dropped, and nothing falls back to the eager solve."""
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    class Syncing(StructuredKKT):
        def solve(self, *args):
            torch.cuda.synchronize()
            return super().solve(*args)

    solver, (z0, cl, cu, zl, zu), _ = _solver("double_integrator_f32", card)
    solver, _, _ = _solver("double_integrator_f32", card, kkt=Syncing(solver.docp, algorithm="cr"))
    with pytest.raises(RuntimeError):
        solver(z0, cl, cu, zl, zu)
    assert solver.captures == 0 and solver.graphs == {}
