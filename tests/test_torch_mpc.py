"""Batched MPC tick: the PyTorch tick (torch.func.vmap of the single-instance
tick, CR block solve through the dispatch) against the JAX tick, both seeded
from ONE JAX cold-start state so that tick parity does not depend on IPM
parity (double integrator, trapeze, N=12, B=3, float64). After
tests/test_lanes.py::test_mpc_resolve_uses_lane_path."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from torch_helpers import jax_docp, n, t, torch_docp

N, B = 12, 3


@pytest.fixture(scope="module")
def seeded():
    from ctdirect_tpu.parallel.mpc import MPCController
    from ctdirect_tpu.solver.ipm import IPMOptions

    dj = jax_docp(grid_size=N)
    ctrl = MPCController(dj, x0_boundary_rows=[0, 1], resolve_iters=2, kkt_algorithm="cr")
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
    x0 = 0.05 * np.random.default_rng(0).standard_normal((B, 2))
    return dict(ctrl_j=ctrl, warm=jax.device_get(warm), x0=x0)


def _torch_ctrl(**kw):
    from ctdirect_tpu_torch.parallel.mpc import MPCController

    return MPCController(torch_docp(grid_size=N), x0_boundary_rows=[0, 1], device="cpu", **kw)


def _seed_states(seeded):
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    return broadcast_state(warm_state_from_numpy(seeded["warm"], "cpu"), B)


def test_cold_start_matches_jax(seeded):
    """MPCController.cold_start (one full IPM solve) lands on the JAX state."""
    from ctdirect_tpu_torch.solver.ipm import IPMOptions

    warm = _torch_ctrl(kkt_algorithm="cr").cold_start(options=IPMOptions(tol=1e-8, max_iter=60))
    np.testing.assert_allclose(n(warm.z), np.asarray(seeded["warm"].z), rtol=0, atol=1e-7)


def test_tick_matches_jax(seeded):
    from ctdirect_tpu.parallel.mpc import broadcast_state as broadcast_j

    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    states_j = broadcast_j(seeded["warm"], B)
    sj, uj, kj, vj = seeded["ctrl_j"](states_j, seeded["x0"])
    ctrl = _torch_ctrl(resolve_iters=2, kkt_algorithm="cr")
    # seeded from the JAX state WITH its batch axis
    st, ut, kt, vt = ctrl(warm_state_from_numpy(jax.device_get(states_j), "cpu"), t(seeded["x0"]))
    for a, b in zip(st, jax.device_get(sj)):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=0, atol=1e-10)
    np.testing.assert_allclose(n(ut), np.asarray(uj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(n(kt), np.asarray(kj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(n(vt), np.asarray(vj), rtol=0, atol=1e-10)


def test_shift_state_matches_jax(seeded):
    from ctdirect_tpu.parallel.mpc import shift_state as shift_j
    from ctdirect_tpu_torch.parallel.mpc import shift_state as shift_t
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    dj, dt = jax_docp(grid_size=N), torch_docp(grid_size=N)
    a = shift_t(dt, warm_state_from_numpy(seeded["warm"], "cpu"))
    b = shift_j(dj, seeded["warm"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(n(x), np.asarray(y))


def test_tick_cr_matches_scan(seeded):
    """The CR block solve and the sequential scan give the same tick."""
    x0 = t(seeded["x0"])
    outs = {}
    for algo in ("cr", "scan"):
        _, u0, kkt, _ = _torch_ctrl(resolve_iters=2, kkt_algorithm=algo)(_seed_states(seeded), x0)
        assert torch.isfinite(u0).all()
        outs[algo] = n(u0)
    np.testing.assert_allclose(outs["cr"], outs["scan"], rtol=1e-9, atol=1e-12)


def test_f32_block_solve_tick_converges(seeded):
    """Fast-tier mixed-precision gate: an f32 CR block solve inside the f64
    Newton loop reaches machine-level KKT, 2 ticks x 3 iterations (the JAX
    package's version of this check is slow-tier only)."""
    ctrl = _torch_ctrl(resolve_iters=3, kkt_algorithm="cr", kkt_solve_dtype=torch.float32)
    states, x0 = _seed_states(seeded), t(seeded["x0"])
    for _ in range(2):
        states, u0, kkt, viol = ctrl(states, x0)
    assert kkt.max().item() < 1e-10, kkt
    assert u0.dtype == torch.float64 and u0.shape == (B, 1)


def test_controller_rejects_unported_and_mismatched_options():
    from ctdirect_tpu_torch.parallel.mpc import MPCController

    d = torch_docp(grid_size=4)
    # a mesh without the named batch axis, a time axis without a mesh
    with pytest.raises(ValueError, match="no axis 'batch'"):
        MPCController(d, [0, 1], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no axis 'rows'"):
        MPCController(d, [0, 1], mesh=SimpleNamespace(mesh_dim_names=("batch",)), batch_axis="rows", device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        MPCController(d, [0, 1], time_axis="time", device="cpu")
    with pytest.raises(ValueError, match="DOCP is on"):
        MPCController(d, [0, 1], device="cpu", dtype=torch.float32)
    # Ruiz and the f32 assembly are ported: they reach the tick's operator
    ctrl = MPCController(d, [0, 1], kkt_solve_dtype=torch.float32, kkt_equilibrate=True,
                         kkt_assemble_dtype=torch.float32, device="cpu")
    assert ctrl.kkt.equilibrate and ctrl.kkt.assemble_dtype == torch.float32
