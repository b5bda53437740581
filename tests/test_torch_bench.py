"""ctdirect_tpu_torch.bench (the port of bench.py) on the CPU: `run` at B=8,
N=20, 4 reps under the f64 and the f32 block solve, every tick's u0 and
KKT held to the JAX package's MPCController built with bench.py's
arguments (jitted, both block solves in one compiled program), seeded from
the port's warm state over the same default_rng(0) draws; the BENCH_*
environment mapping and its two refusals; the JSON line's keys (kept,
dropped, added); the cost helpers at PERF.md's rows; the roofline's
share. On the card (marked `cuda`, skipped without one; no JAX needed:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_bench.py`): `run` and `report` at full width and 10 reps."""

import numpy as np
import pytest
import torch

from ctdirect_tpu_torch import bench

SMALL = dict(bench.DEFAULT_CFG, N=20, B=8, reps=4)
# every tick of the port's bench against the JAX package's, absolute on u0
# and KKT, as the other f64 parity tests: under the f32 block solve too, the
# f64 Newton loop contracts the two packages' f32 rounding (measured on a
# CPU: at most 2.7e-15 under either block solve)
TOL = 1e-10

KEPT = {"metric", "value", "unit", "tick_ms_p50", "tick_ms_p90", "tick_ms_synced_p50", "tick_compile_s",
        "cold_start_s", "kkt_solve_dtype", "kkt_max", "reps", "hbm_util", "achieved_gbps", "achieved_gflops"}
DROPPED = {"vs_baseline", "mfu_f32peak"}
ADDED = {"card", "cr_launches_per_tick", "tick_ms_event_p50", "tick_ms_event_p90", "bound_ms", "stage_ms"}


@pytest.fixture(scope="module")
def runs():
    return {f32: bench.run(dict(SMALL, solve_f32=f32), device="cpu", log=lambda m: None) for f32 in (True, False)}


@pytest.fixture(scope="module")
def jax_ticks(runs):
    """Each run's ticks through the JAX package's bench tick (bench.py's
    MPCController arguments), from that run's warm state over the same
    x0 draws: the first tick, the reps pipelined, the reps synchronized."""
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.resolve import WarmState

    docp = transcribe(get_problem(bench.PROBLEM).ocp, grid_size=SMALL["N"], scheme="trapeze")
    ctrls = {f32: MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=SMALL["iters"], kkt_algorithm="cr",
                                kkt_solve_dtype=jnp.float32 if f32 else None, kkt_pivot=True,
                                kkt_assemble_dtype=None, resolve_loop="unroll")
             for f32 in (True, False)}
    both = jax.jit(lambda s32, s64, x0: (ctrls[True](s32, x0), ctrls[False](s64, x0)))
    states = {f32: broadcast_state(WarmState(*(jnp.asarray(r["warm"][f]) for f in WarmState._fields)), SMALL["B"])
              for f32, r in runs.items()}
    rng = np.random.default_rng(0)
    B, reps = SMALL["B"], SMALL["reps"]
    x0 = jnp.asarray(bench.X0_SCALE * rng.standard_normal((B, 2)))
    xs = [jnp.asarray(bench.X0_SCALE * rng.standard_normal((B, 2))) for _ in range(reps)]
    out = {f32: dict(u0s=[], kkts=[]) for f32 in runs}
    for x in [x0, *xs, *xs]:
        (states[True], u32, k32, _), (states[False], u64, k64, _) = both(states[True], states[False], x)
        for f32, (u0, kkt) in ((True, (u32, k32)), (False, (u64, k64))):
            out[f32]["u0s"].append(np.asarray(u0))
            out[f32]["kkts"].append(np.asarray(kkt))
    return out


@pytest.mark.parametrize("f32", [False, True], ids=["f64_block_solve", "f32_block_solve"])
def test_bench_ticks_match_jax(runs, jax_ticks, f32):
    """Every tick of the port's bench (1 + 2 x reps) against the JAX
    package's: u0 and KKT within TOL, the KKT below the bench's limit in
    both, and the run passing report's checks."""
    got, want = runs[f32], jax_ticks[f32]
    assert len(got["u0s"]) == len(want["u0s"]) == 1 + 2 * SMALL["reps"]
    for k, (a, b) in enumerate(zip(got["u0s"], want["u0s"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=f"u0 at tick {k}")
    for k, (a, b) in enumerate(zip(got["kkts"], want["kkts"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=f"KKT at tick {k}")
    assert max(k.max() for k in want["kkts"]) < bench.KKT_LIMIT and got["kkt_max"] < bench.KKT_LIMIT
    line, failed = bench.report(got, log=lambda m: None)
    assert failed == [] and line["kkt_solve_dtype"] == ("f32" if f32 else "f64"), (line, failed)
    assert got["u0_shape"] == (SMALL["B"], 1) and got["bitwise"]


def test_environment_mapping_and_refusals(monkeypatch):
    """The reference's BENCH_* names set the same knobs; BENCH_PIVOT=0 and a
    BENCH_LOOP other than unroll are refused, by main with exit code 2."""
    assert bench.config_from_env({}) == bench.DEFAULT_CFG
    cfg = bench.config_from_env(dict(BENCH_N="50", BENCH_BATCH="4096", BENCH_ITERS="2", BENCH_ALGO="scan",
                                     BENCH_SOLVE_F32="0", BENCH_ASM_F32="1", BENCH_REPS="7", BENCH_F32="1",
                                     BENCH_PIVOT="1", BENCH_LOOP="unroll"))
    assert cfg == dict(N=50, B=4096, iters=2, algo="scan", solve_f32=False, asm_f32=True, f32=True, reps=7)
    assert bench.config_from_env(dict(BENCH_SOLVE_F32="1", BENCH_ASM_F32="0", BENCH_F32="0")) == bench.DEFAULT_CFG
    with pytest.raises(ValueError, match="pivotless"):
        bench.config_from_env(dict(BENCH_PIVOT="0"))
    with pytest.raises(ValueError, match="BENCH_LOOP=scan"):
        bench.config_from_env(dict(BENCH_LOOP="scan"))
    monkeypatch.setenv("BENCH_PIVOT", "0")
    assert bench.main(["--cpu"]) == 2
    monkeypatch.delenv("BENCH_PIVOT")
    monkeypatch.setenv("BENCH_LOOP", "fori")
    assert bench.main(["--cpu"]) == 2


def test_no_card_exits_nonzero(monkeypatch):
    """Without a card and without --cpu the bench refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1


def test_json_line_keys(runs):
    """The line keeps the reference's keys but vs_baseline and mfu_f32peak,
    adds the card, the launches, the CUDA-event times, the bound and the
    stage split; on the CPU every device rate is null."""
    line, _ = bench.report(runs[True], log=lambda m: None)
    assert KEPT <= set(line) and ADDED <= set(line) and not DROPPED & set(line), set(line)
    assert line["metric"] == "warm-start MPC solves/s/card, N=20 trapezoid" and line["unit"] == "solves/s"
    assert line["value"] == pytest.approx(SMALL["B"] / (line["tick_ms_p50"] / 1e3))
    assert line["card"] == "cpu" and line["reps"] == SMALL["reps"]
    for key in ("hbm_util", "achieved_gbps", "achieved_gflops", "tick_ms_event_p50", "cr_launches_per_tick"):
        assert line[key] is None, key


def test_solve_cost_at_the_perf_rows():
    """The cost helpers give PERF.md section 6's bound column: the CR
    kernel's tick row, the scan kernel's orbit row."""
    from ctdirect_tpu_torch.solver import cr_kernel, scan_kernel

    c = cr_kernel.solve_cost(torch.float32, 128, 5, 7, 512)
    assert round(c.bytes / 1e6, 2) == 25.03 and round(c.flops / 1e9, 3) == 0.227
    assert c.bound_by == "bytes" and round(1e3 * c.bound_ms, 3) == 7.472
    c = cr_kernel.solve_cost(torch.float64, 256, 30, 11, 256)
    assert c.bound_by == "operations" and round(1e3 * c.bound_ms, 1) == 392.6
    s = scan_kernel.solve_cost(torch.float64, 500, 11, 13, 1)
    assert round(s.bytes / 1e6, 3) == 1.629 and s.bound_by == "bytes" and round(1e3 * s.bound_ms, 3) == 0.486
    assert scan_kernel.latency_floor_ms(torch.float64, 500, 11, 13) > s.bound_ms


def test_roofline_is_a_lower_bound(runs):
    """The tick's counted work holds ITERS block solves and the warm state
    moved once; at any tick time at or above its bound, hbm_util <= 1."""
    from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu_torch.solver import cr_kernel
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy
    from torch_helpers import torch_docp

    ctrl = MPCController(torch_docp(grid_size=SMALL["N"]), x0_boundary_rows=[0, 1], kkt_algorithm="cr",
                         kkt_solve_dtype=torch.float32, device="cpu")
    states = broadcast_state(warm_state_from_numpy(runs[True]["warm"], "cpu"), SMALL["B"])
    work = bench.roofline(SMALL, ctrl, states)
    solve = cr_kernel.solve_cost(torch.float32, 32, ctrl.kkt.d.bs, ctrl.kkt.d.wb, SMALL["B"])
    state_bytes = 8 * sum(a.numel() for a in states)
    assert work["bytes"] == 3 * solve.bytes + 2 * state_bytes + 8 * SMALL["B"] * 5 and work["flops"] == 3 * solve.flops
    assert "hbm_util" not in work
    for scale in (1.0, 1.5, 40.0):
        rates = bench.roofline(SMALL, ctrl, states, scale * work["bound_ms"])
        assert rates["hbm_util"] <= 1.0 and rates["bound_ms"] == work["bound_ms"]


@pytest.mark.cuda
def test_bench_on_card():
    """run and report on the card at full width and 10 reps, both block
    solves: every check passes, the CR kernel launches 3 times a tick, the
    rates are the card's and hbm_util stays at most 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CR and scan kernels have no CPU mode")
    for f32 in (True, False):
        result = bench.run(dict(bench.DEFAULT_CFG, reps=10, solve_f32=f32), device="cuda", log=lambda m: None)
        line, failed = bench.report(result, log=lambda m: None)
        assert failed == [], failed
        assert line["cr_launches_per_tick"] == 3 and line["scan_launches_per_tick"] == 0
        assert line["kkt_max"] < bench.KKT_LIMIT and line["bitwise"]
        assert 0 < line["hbm_util"] <= 1 and line["tick_ms_p50"] >= line["bound_ms"]
