"""The compiled MPC tick: the port's counterpart of `jax.jit(vtick)` is the
tick captured as a CUDA graph and replayed (solver/graph.py::CallGraph).

On the CPU (no card): every tick the card captures makes no capture-illegal
call (`CaptureHazards`), the constants hoisted out of the callbacks leave
the tick bit for bit as it was, a CPU controller runs the eager tick, and
the Gauss-Legendre tick equals the JAX package's jitted tick. On the card
(marked `cuda`, skipped without one; the card tests need no JAX: `python -m
pytest --noconftest -p no:cacheprovider tests/test_torch_tick_graph.py`):
the same hazard check on CUDA tensors, the replay against the eager tick,
what a tick returns after the next one, one capture per signature, the
counters under replay, and a capture that fails raising."""

import numpy as np
import pytest
import torch

from torch_helpers import DI, CaptureHazards, n

N, B = 8, 3
ITERS = 2


# the ticks the card captures: (problem, scheme, x0 rows, controller options)
TICKS = {
    "double_integrator_cr_f64": (DI, "trapeze", [0, 1], {}),
    "double_integrator_cr_f32": (DI, "trapeze", [0, 1], dict(kkt_solve_dtype=torch.float32)),
    "cartpole": ("cartpole", "trapeze", [0, 1, 2, 3], {}),
    "gauss_legendre_2": (DI, "gauss_legendre_2", [0, 1], {}),
}


def _controller(case, device, **kw):
    """(controller, its cold-start warm state, x0 width) of one TICKS case."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel.mpc import MPCController
    from ctdirect_tpu_torch.problems import get_problem

    name, scheme, rows, opts = TICKS[case]
    prob = get_problem(name)
    docp = ct.transcribe(prob.ocp, grid_size=N, scheme=scheme, device=device)
    ctrl = MPCController(docp, x0_boundary_rows=rows, resolve_iters=ITERS, kkt_algorithm="cr", device=device,
                         **opts, **kw)
    warm = ctrl.cold_start(options=ct.IPMOptions(tol=1e-8, max_iter=60), init=prob.init)
    return ctrl, warm, len(rows)


def _x0s(width, batch, count, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(0.02 * rng.standard_normal((batch, width)), dtype=torch.float64, device=device)
            for _ in range(count)]


def _flat(out):
    """A tick's results (new states, u0, kkt, viol) as one tuple of tensors."""
    return (*out[0], *out[1:])


def _hazards(case, device):
    """The hazards of a case's first tick (the card's warm-up runs it just
    so); the tick under the mode is also bit for bit the tick without it."""
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    ctrl, warm, width = _controller(case, device)
    states, x0 = broadcast_state(warm, B), _x0s(width, B, 1, device)[0]
    mode = CaptureHazards()
    with mode:
        out = ctrl.eager(states, x0)
    for a, b in zip(_flat(out), _flat(ctrl.eager(states, x0))):
        assert torch.equal(a, b)
    return mode


@pytest.mark.parametrize("case", sorted(TICKS))
def test_tick_makes_no_capture_hazard(case):
    mode = _hazards(case, "cpu")
    assert mode.seen == [], mode.where


def test_hazard_mode_sees_host_data_and_syncs():
    """The mode's witness: a tensor made from a host value (inside vmap too)
    and an `.item()` are recorded."""
    x = torch.ones(3, 2, dtype=torch.float64)
    mode = CaptureHazards()
    with mode:
        torch.func.vmap(lambda r: r + torch.as_tensor(1.5, dtype=r.dtype, device=r.device))(x)
        x.sum().item()
    assert mode.seen == ["aten::lift_fresh", "aten::_local_scalar_dense"]


def test_hoisted_tableau_leaves_the_gl_tick_bit_for_bit(monkeypatch):
    """The Gauss-Legendre tick with the tableau made once per device and dtype
    == the tick with the tableau converted on every call (the code before
    it was hoisted)."""
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state
    from ctdirect_tpu_torch.transcription.schemes import GenericIRK

    ctrl, warm, width = _controller("gauss_legendre_2", "cpu")
    states, x0 = broadcast_state(warm, B), _x0s(width, B, 1, "cpu")[0]
    hoisted = ctrl.eager(states, x0)
    assert len(ctrl.docp.scheme._tables) == 1  # the DOCP's own, made at construction

    def per_call(self, like):
        return tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device) for a in (self.A, self.b, self.c))

    monkeypatch.setattr(GenericIRK, "_tableau", per_call)
    for a, b in zip(_flat(hoisted), _flat(ctrl.eager(states, x0))):
        assert torch.equal(a, b)


def test_constant_callable_output_is_made_once():
    """A user callable that returns a Python constant: the DOCP makes its
    tensor at the first call, here inside `torch.func.hessian` (as the KKT
    operator's `prepare` calls the callbacks), and reuses it in later
    transforms and outside them (no tensor from host data after that), with
    the value of a per-call conversion; another dtype gets its own."""
    from ctdirect_tpu_torch import transcribe
    from ctdirect_tpu_torch.model.ocp import PreOCP

    pre = PreOCP("di_bolza")
    pre.state(2).control(1)
    pre.time(t0=0.0, tf=1.0)
    pre.dynamics(lambda t, x, u, v: torch.stack([x[1], u[0]]))
    pre.objective(mayer=lambda x0, xf, v: 0.25, lagrange=lambda t, x, u, v: u[0] ** 2)
    pre.initial_state([0.0, 0.0]).final_state([1.0, 0.0])
    d = transcribe(pre.build(), grid_size=4, scheme="trapeze", device="cpu")
    z = torch.linspace(0.0, 1.0, d.nz, dtype=torch.float64)
    first, second = CaptureHazards(), CaptureHazards()
    with first:
        ha = torch.func.hessian(d.objective)(z)
    with second:
        hb = torch.func.hessian(d.objective)(z)
        a = d.objective(z)
    assert first.seen == ["aten::lift_fresh"] and second.seen == []
    assert torch.equal(ha, hb)
    assert torch.equal(a - 0.25, d.objective(z) - d._mayer(z[:2], z[:2], z[:0]))
    assert torch.equal(d._mayer(z[:2], z[:2], z[:0]), torch.as_tensor(0.25, dtype=torch.float64))
    assert d._mayer(z[:2].float(), z[:2].float(), z[:0].float()).dtype == torch.float32
    assert len(d._consts) == 2


def test_cpu_controller_runs_the_eager_tick():
    """On the CPU `__call__` is the eager tick: nothing captured, the same
    results as `eager` bit for bit."""
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    ctrl, warm, width = _controller("double_integrator_cr_f64", "cpu")
    states, x0 = broadcast_state(warm, B), _x0s(width, B, 1, "cpu")[0]
    for a, b in zip(_flat(ctrl(states, x0)), _flat(ctrl.eager(states, x0))):
        assert torch.equal(a, b)
    assert ctrl.captures == 0 and ctrl.graphs == {}


def test_gl2_tick_matches_jax():
    """The Gauss-Legendre 2 tick (the path whose tableau was hoisted) against
    the JAX package's jitted tick from the same state and x0 (f64; the same
    formulas, so 1e-10 as tests/test_torch_mpc.py)."""
    jax = pytest.importorskip("jax")
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.parallel.mpc import MPCController as MPCJ
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu.solver.resolve import WarmState as WarmJ

    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    ctrl, warm, width = _controller("gauss_legendre_2", "cpu")
    states, x0 = broadcast_state(warm, B), _x0s(width, B, 1, "cpu")[0]
    out = ctrl(states, x0)
    dj = transcribe_j(problem_j(DI).ocp, grid_size=N, scheme="gauss_legendre_2")
    ctrl_j = MPCJ(dj, x0_boundary_rows=[0, 1], resolve_iters=ITERS, kkt_algorithm="cr")
    out_j = jax.device_get(ctrl_j(WarmJ(*(n(a) for a in states)), n(x0)))
    for a, b in zip(_flat(out), (*out_j[0], *out_j[1:])):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-10)


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------


@pytest.fixture
def card():
    """The card, with the CR kernel's counts put back after the test as they
    were before it (the kernel's wrapper is one object per process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tick's graph and the CR kernel have no CPU mode")
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    counts = kernel.launches, kernel.grid_launches
    yield "cuda"
    kernel.launches, kernel.grid_launches = counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TICKS))
def test_tick_makes_no_capture_hazard_on_card(card, case):
    mode = _hazards(case, card)
    assert mode.seen == [], mode.where


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TICKS))
def test_replay_matches_eager_on_card(card, case):
    """Three ticks, each from the same states and x0 through the replay and
    the eager tick: equal to 1e-13 abs (the same kernels in the same order;
    room for a library that picks another algorithm on another stream)."""
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    ctrl, warm, width = _controller(case, card)
    states = broadcast_state(warm, B)
    for x0 in _x0s(width, B, 3, card):
        replayed, eager = ctrl(states, x0), ctrl.eager(states, x0)
        for a, b in zip(_flat(replayed), _flat(eager)):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert (a - b).abs().max().item() <= 1e-13
        states = eager[0]
    assert ctrl.captures == 1


@pytest.mark.cuda
def test_returned_tensors_survive_the_next_tick_on_card(card):
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    ctrl, warm, width = _controller("double_integrator_cr_f64", card)
    xa, xb = _x0s(width, B, 2, card)
    first = ctrl(broadcast_state(warm, B), xa)
    kept = [a.clone() for a in _flat(first)]
    second = ctrl(first[0], xb)
    for a, b in zip(_flat(first), kept):
        assert torch.equal(a, b)
    assert not torch.equal(second[1], first[1])  # the replay saw the new inputs
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(_flat(first), _flat(second)))


@pytest.mark.cuda
def test_a_new_batch_size_captures_again_on_card(card):
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    ctrl, warm, width = _controller("double_integrator_cr_f64", card)
    for batch, captures in ((B, 1), (B + 2, 2), (B, 2), (B + 2, 2)):
        _, u0, _, _ = ctrl(broadcast_state(warm, batch), _x0s(width, batch, 1, card)[0])
        assert u0.shape == (batch, 1) and ctrl.captures == captures
    assert len(ctrl.graphs) == 2


@pytest.mark.cuda
def test_counters_grow_by_replays_times_captured_on_card(card):
    """The first call warms up (one eager tick, its launches real), captures
    (no launch) and replays; each replay adds what the capture added: ITERS
    block solves, ITERS kernel solves of 3 + 3 log2 P CUDA launches each."""
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    ctrl, warm, width = _controller("double_integrator_cr_f64", card)
    states, xs = broadcast_state(warm, B), _x0s(width, B, 5, card)
    P = 1 << (N - 1).bit_length()
    per_solve = len(kernel.plan(P, 1, 0, 1, 8))
    kernel.reset_counts()
    solves0 = ctrl.kkt.block_solves
    states, *_ = ctrl(states, xs[0])
    assert kernel.launches == 2 * ITERS and ctrl.kkt.block_solves - solves0 == 2 * ITERS
    for k, x0 in enumerate(xs[1:], start=1):
        states, *_ = ctrl(states, x0)
        assert kernel.launches == (2 + k) * ITERS
    assert kernel.grid_launches == kernel.launches * per_solve
    assert ctrl.kkt.block_solves - solves0 == kernel.launches


@pytest.mark.cuda
def test_a_failing_capture_raises_on_card(card):
    """A KKT operator that waits for the device inside the tick runs eagerly
    but cannot be captured: the call raises, nothing is kept, and nothing
    falls back to the eager tick."""
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    class Syncing(StructuredKKT):
        def solve(self, *args):
            torch.cuda.synchronize()
            return super().solve(*args)

    ctrl, warm, width = _controller("double_integrator_cr_f64", card,
                                    kkt_factory=lambda d: Syncing(d, algorithm="cr"))
    states, x0 = broadcast_state(warm, B), _x0s(width, B, 1, card)[0]
    with pytest.raises(RuntimeError):
        ctrl(states, x0)
    assert ctrl.captures == 0 and ctrl.graphs == {}
