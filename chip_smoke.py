"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no result):
  1. the card's name and power limit (nvidia-smi);
  2. build the CR kernel from ctdirect_tpu_torch/csrc/cr_solve.cu;
  3. kernel vs its plain PyTorch version at the MPC tick shape
     (P=128, bs=5, wb=7, B=512) in float32 and float64, plus a dense-residual
     check on 3 lanes; times of both (CUDA events, median of 20 calls);
  4. the front door: ct.solve(double integrator, N=100, trapeze) on the card
     against its analytic oracles;
  5. the main path: cold start + 512 warm-started MPC controllers at N=100,
     3 Newton steps per tick, with the f32 and then the f64 block solve; the
     kernel's launch count must grow by exactly ticks x 3 and max KKT stay
     below 1e-10;
  6. the device split of 5 more ticks of each (torch.profiler): device busy
     and idle share, the CR kernel's share, kernel launches per tick.
The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, N, ITERS = 512, 100, 3
P_TICK, BS_TICK, WB_TICK = 128, 5, 7
WARMUP_TICKS, TIMED_TICKS = 2, 30
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
RESID_TOL = {torch.float32: 2e-4, torch.float64: 1e-12}


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(out)
    return out


def random_chain(P, bs, wb, B, dtype, seed=0):
    """The tests' random well-conditioned symmetric chain (the CR recurrences
    assume symmetric A and F), lane-minor, on the card."""
    from torch_helpers import random_chain_lanes

    host = random_chain_lanes(P, bs, wb, B, seed=seed)
    return tuple(torch.tensor(x, dtype=dtype, device="cuda") for x in host)


def median_ms(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_kernel_vs_plain(kernel):
    from torch_helpers import relative_residual

    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes

    results = {}
    for dtype in (torch.float32, torch.float64):
        chain = random_chain(P_TICK, BS_TICK, WB_TICK, B, dtype)
        X, xb = kernel(*chain)
        Xp, xbp = cr_solve_lanes(*chain)
        torch.cuda.synchronize()
        for name, t in (("X", X), ("xb", xb)):
            if t.shape != (Xp if name == "X" else xbp).shape or not torch.isfinite(t).all():
                raise AssertionError(f"kernel {dtype}: {name} not finite or wrong shape")
        err = max((X - Xp).abs().max().item(), (xb - xbp).abs().max().item())
        scale = max(1.0, Xp.abs().max().item(), xbp.abs().max().item())
        if not err <= TOL[dtype] * scale:
            raise AssertionError(f"kernel vs plain {dtype}: max abs err {err:.3e} > {TOL[dtype]:.0e} x {scale:.3g}")
        resid = max(relative_residual(chain, X, xb, lane) for lane in (0, 7, B - 1))
        if not resid < RESID_TOL[dtype]:
            raise AssertionError(f"kernel {dtype}: dense residual {resid:.3e}")
        ms = median_ms(lambda: kernel(*chain))
        plain_ms = median_ms(lambda: cr_solve_lanes(*chain))
        log(f"CR kernel {dtype} at P={P_TICK} bs={BS_TICK} wb={WB_TICK} B={B}: max abs err "
            f"{err:.3e} vs plain, dense residual {resid:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(CUDA events, median of 20)")
        results[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def phase_front_door(ct, get_problem):
    t0 = time.perf_counter()
    p = get_problem("double_integrator_minenergy")
    sol = ct.solve(p.ocp, grid_size=N, scheme="trapeze", tol=1e-8, device="cuda")
    secs = time.perf_counter() - t0
    if not sol.successful:
        raise AssertionError(f"front door: {sol.message}")
    t = sol.time_grid
    u = sol.control_values[:, 0]
    if not np.max(np.abs(u[2:-2] - (6 - 12 * t[2:-2]))) < 5e-3:
        raise AssertionError("front door: interior control error")
    np.testing.assert_allclose(sol.objective, 12.0, rtol=1e-2)
    Pc = sol.costate_values
    np.testing.assert_allclose(Pc[:-1, 0], 24.0, rtol=1e-2)
    tm = 0.5 * (t[:-1] + t[1:])
    np.testing.assert_allclose(Pc[:-1, 1], 12 - 24 * tm, rtol=1e-2, atol=0.05)
    log(f"front door: solve N={N} trapeze on cuda: status {sol.status}, {sol.iterations} "
        f"iterations, objective {sol.objective:.10g}, p(0) = {Pc[0]}, {secs:.2f} s wall")


def phase_main_path(ct, get_problem, kernel, solve_dtype, xs):
    from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state

    p = get_problem("double_integrator_minenergy")
    docp = ct.transcribe(p.ocp, grid_size=N, scheme="trapeze", device="cuda")
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=ITERS, kkt_algorithm="cr",
                         kkt_solve_dtype=solve_dtype, device="cuda")
    t0 = time.perf_counter()
    warm = ctrl.cold_start(options=ct.IPMOptions(tol=1e-8, max_iter=60))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    states = broadcast_state(warm, B)

    kernel.launches = 0
    tick_ms, host_ms, kkt_max = [], [], 0.0
    for k, x0 in enumerate(xs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        states, u0, kkt, viol = ctrl(states, x0)
        end.record()
        end.synchronize()
        if k >= WARMUP_TICKS:
            tick_ms.append(start.elapsed_time(end))
            host_ms.append((time.perf_counter() - h0) * 1e3)
        kkt_max = max(kkt_max, kkt.max().item())
    launches = kernel.launches

    name = "f32" if solve_dtype == torch.float32 else "f64"
    if launches != len(xs) * ITERS:
        raise AssertionError(f"{name} tick: kernel launched {launches} times, want {len(xs) * ITERS}")
    if u0.shape != (B, 1) or not torch.isfinite(u0).all():
        raise AssertionError(f"{name} tick: u0 not finite or wrong shape {tuple(u0.shape)}")
    if not kkt_max < 1e-10:
        raise AssertionError(f"{name} tick: max KKT {kkt_max:.3e} >= 1e-10")
    p50, p90 = np.percentile(tick_ms, 50), np.percentile(tick_ms, 90)
    log(f"main path, {name} block solve: cold start {cold_s:.2f} s; {len(xs)} ticks x B={B} "
        f"N={N} x {ITERS} Newton steps; tick {p50:.3f} ms p50 / {p90:.3f} ms p90 (CUDA events), "
        f"host {np.percentile(host_ms, 50):.3f} ms p50 -> {B / (p50 / 1e3):.1f} solves/s; "
        f"max KKT {kkt_max:.3e}; kernel launches {launches}")
    return dict(launches=launches, u0=u0, ctrl=ctrl, states=states)


def phase_device_split(name, ctrl, states, xs, ticks=5):
    """Device busy/idle share of a few ticks and the CR kernel's part of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x0 in xs[:ticks]:
            states, *_ = ctrl(states, x0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / ticks * 1e3
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev) / ticks / 1e3
    cr = sum(e.self_device_time_total for e in dev if "cr_solve_kernel" in e.key) / ticks / 1e3
    launches = sum(e.count for e in dev) / ticks
    if not busy > 0:
        raise AssertionError("profiler saw no device time")
    log(f"device split, {name} block solve ({ticks} ticks under torch.profiler): wall {wall:.3f} ms/tick, "
        f"device busy {busy:.3f} ms/tick ({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), "
        f"CR kernel {cr:.3f} ms/tick ({100 * cr / busy:.1f}% of busy), other kernels {busy - cr:.3f} ms/tick, "
        f"{launches:.0f} kernel launches/tick")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    # the random test chains and the dense-residual oracle are the CPU tests' own
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    path, build_s, build_log = kernel.library(verbose=True)
    log(f"built {path.name} in {build_s:.2f} s")
    for line in build_log.splitlines():
        if line.strip():
            log(f"  nvcc: {line.strip()}")

    kres = phase_kernel_vs_plain(kernel)
    phase_front_door(ct, get_problem)

    rng = np.random.default_rng(0)
    xs = [torch.tensor(0.03 * rng.standard_normal((B, 2)), dtype=torch.float64, device="cuda")
          for _ in range(WARMUP_TICKS + TIMED_TICKS)]
    main = {dt: phase_main_path(ct, get_problem, kernel, dt, xs) for dt in (torch.float32, torch.float64)}
    du = (main[torch.float32]["u0"] - main[torch.float64]["u0"]).abs().max().item()
    if not du < 1e-8:
        raise AssertionError(f"f32 vs f64 block solve: final u0 differ by {du:.3e}")
    log(f"f32 vs f64 block solve: final u0 agree to {du:.3e}")
    for dt, m in main.items():
        phase_device_split("f32" if dt == torch.float32 else "f64", m["ctrl"], m["states"], xs)

    kernels = [
        dict(name=f"cr_solve_{tag}", route="cuda", source="ctdirect_tpu_torch/csrc/cr_solve.cu",
             replaces="ctdirect_tpu/solver/pallas_cr.py:281", launches=main[dt]["launches"],
             max_abs_err=kres[dt]["max_abs_err"], ms=kres[dt]["ms"], plain_ms=kres[dt]["plain_ms"])
        for tag, dt in (("f32", torch.float32), ("f64", torch.float64))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
