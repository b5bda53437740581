"""The benchmark's yardstick against the program on the CPU: the frozen cost
copy against the program's `cr_kernel.solve_cost`, the chain's shape against
the program's KKT operator, and the plain reference against the port's CPU
path at a small batch and grid, for both configurations.

    python -m pytest -p no:cacheprovider perfbench/tests
"""

import importlib

import numpy as np
import pytest
import torch

from perfbench import cost, generator, harness, program
from perfbench.reference import trapeze

CONFIGS = ("di_mpc_trapeze_n100", "cartpole_mpc_trapeze_n60")
CELL = {"di_mpc_trapeze_n100": "di_tick_b512", "cartpole_mpc_trapeze_n60": "cartpole_batch_b1024"}
SMALL_N, SMALL_B = 12, 3
# the cart-pole tick has no cell (PERF.md, Open questions): its limits as sound runs on the H100 set
# them (u0 2.5e-9, state 7.0e-8 over 18 seeds)
CARTPOLE_TICK_LIMITS = {"u0_gap": 1e-7, "state_gap": 1e-5}


def _spec(config, **sizes):
    spec = harness.load(CELL[config])
    return dict(spec["cfg"], **sizes), spec["mix"]


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("shape", ((100, 5, 7, 512), (60, 9, 13, 1024), (8192, 10, 12, 1)))
def test_frozen_cost_is_the_programs(shape, dtype):
    from ctdirect_tpu_torch.solver import cr_kernel

    P, bs, wb, B = shape
    mine = cost.block_solve(torch.finfo(dtype).bits // 8, P, bs, wb, B)
    theirs = cr_kernel.solve_cost(dtype, P, bs, wb, B)
    assert mine == pytest.approx((theirs.bytes, theirs.flops), rel=1e-12)
    assert cost.bound_s(*mine) * 1e3 == pytest.approx(theirs.bound_ms, rel=1e-12)


@pytest.mark.parametrize("config", CONFIGS)
def test_chain_shape_is_the_operators(config):
    cfg, _ = _spec(config)
    _, docp = program.transcribe(cfg, "cpu", torch.float64)
    d = program.controller(cfg, docp, None).kkt.d
    assert cost.trapeze_chain(docp.n, docp.m, cfg["grid_size"]) == (d.N, d.bs, d.wb)


@pytest.mark.parametrize("config", CONFIGS)
def test_transcription_is_the_programs(config):
    """The reference's objective, constraints and bounds against the
    program's DOCP at random points (the layout both sides read)."""
    cfg, _ = _spec(config, grid_size=SMALL_N)
    _, docp = program.transcribe(cfg, "cpu", torch.float64)
    tr = trapeze.Trapeze(cfg, importlib.import_module(f"perfbench.reference.{config}"))
    assert (tr.nz, tr.nc) == (docp.nz, docp.nc)
    np.testing.assert_array_equal(tr.z_lb, docp._z_lb)
    np.testing.assert_array_equal(tr.z_ub, docp._z_ub)
    np.testing.assert_array_equal(tr.c_lb, docp._c_lb)
    z = torch.tensor(np.random.default_rng(0).standard_normal(tr.nz))
    assert float(tr.objective(z)) == pytest.approx(float(docp.nlp_objective(z)), rel=1e-14)
    torch.testing.assert_close(tr.constraints(z), docp.constraints(z), rtol=1e-13, atol=1e-13)
    rows = docp.boundary_row_indices()[cfg["x0_rows"]]
    np.testing.assert_array_equal(tr.x0_rows, rows)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_tick_is_the_programs(config):
    """Two ticks of the port's controller on the CPU from its cold start
    (the CR solve in its plain form, the configuration's precision) against
    the reference's ticks from the same states: u0 and the state within the
    tick cell's limits by the harness's measure (relative to max(1, |.|_inf)),
    the KKT error to rounding."""
    cfg, mix = _spec(config, grid_size=SMALL_N)  # the cart-pole's x0 draws: the batch cell's
    dtype, solve_dtype = program.precision(cfg)
    prob, docp = program.transcribe(cfg, "cpu", dtype)
    ctrl = program.controller(cfg, docp, solve_dtype)
    states = program.broadcast(program.cold_start(cfg, prob, docp, ctrl)[0], SMALL_B)
    tr = trapeze.Trapeze(cfg, importlib.import_module(f"perfbench.reference.{config}"))
    pool = torch.from_numpy(generator.x0_pool(dict(mix, batch=SMALL_B), 7, 2, slice(0, SMALL_B)))
    limits = harness.load("di_tick_b512")["limits"]["max"] if config == "di_mpc_trapeze_n100" else CARTPOLE_TICK_LIMITS

    def gap(a, b):
        return float(((a - b).abs().amax(dim=1) / torch.clamp(b.abs().amax(dim=1), min=1.0)).max())

    for x0 in pool:
        new, u0, kkt, _ = ctrl(states, x0)
        ref, ref_u0, ref_kkt = torch.func.vmap(lambda s, x: trapeze.tick(tr, s, x, cfg["newton_steps"]))(
            trapeze.State(*states), x0)
        assert gap(u0, ref_u0) <= limits["u0_gap"]
        assert max(gap(a, b) for a, b in zip(new, ref) if a.shape[1]) <= limits["state_gap"]
        torch.testing.assert_close(kkt, ref_kkt, rtol=1e-6, atol=1e-12)
        states = new


def test_reference_judges_the_batch_solver():
    """The port's BatchSolver on the CPU (eager) at a small batch: every
    instance it calls converged meets its tolerance by the reference's
    measure, and its objective is the reference's of its z."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel.batch import BatchSolver

    config = "cartpole_mpc_trapeze_n60"
    cfg, _ = _spec(config, grid_size=SMALL_N)
    mix = harness.load("cartpole_batch_b1024")["mix"]
    prob, docp = program.transcribe(cfg, "cpu", torch.float64)
    warm, _ = program.cold_start(cfg, prob, docp, program.controller(cfg, docp, None))
    solver = BatchSolver(docp, ct.IPMOptions(**cfg["batch_solver"]), device="cpu")
    x0 = torch.from_numpy(generator.x0_pool(dict(mix, batch=4), 3, 1, slice(0, 4))[0])
    tr = trapeze.Trapeze(cfg, importlib.import_module(f"perfbench.reference.{config}"))
    cl, cu = tr.rhs(x0)
    z0 = warm.z.expand(4, -1)
    res = solver(z0, cl, cu)
    err = torch.func.vmap(lambda *a: trapeze.ipm_kkt_error(tr, *a))(z0, x0, res.z, res.lam, res.zL, res.zU)
    assert bool(res.successful.any())
    assert bool((err[res.successful] <= cfg["batch_solver"]["tol"]).all()), err
    torch.testing.assert_close(torch.func.vmap(tr.objective)(res.z), res.objective, rtol=1e-13, atol=1e-13)
