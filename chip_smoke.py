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
     and idle share, the CR kernel's share, kernel launches per tick;
  7. the front door with the default scheme (midpoint): ct.solve(double
     integrator, N=100) with no scheme= against the same analytic oracles;
  8. the cart-pole MPC tick (BASELINE config 3): cold start + 1024 warm-started
     controllers at N=60 trapeze, 3 Newton steps, f64 block solve through the
     CAP=32 kernel; 2 warm-up + 10 timed ticks, launches = ticks x 3;
  9. batched cart-pole scenario solves: BatchSolver (kkt_mode="cr", tol 1e-6,
     30 iterations at most) over 1024 instances with per-instance x0, from the
     cold-start solution; launches = the batched KKT solves, three instances
     re-solved unbatched must match, converged share >= CP_MIN_CONVERGED.
Phase 3 also holds the kernel against its plain version at the cart-pole
chain (P=64, bs=9, wb=13, B=1024, f64). Each path's launches are counted from
zero just before it runs and read just after.
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
# cart-pole (benchmarks/mpc_cartpole.py: N=60, B=1024, 3 Newton steps)
CP_N, CP_B, CP_WARMUP, CP_TICKS = 60, 1024, 2, 10
P_CP, BS_CP, WB_CP = 64, 9, 13  # its trapeze KKT chain (padded to a power of two)
CP_UMAX = 12.0
CP_BATCH, CP_CHECK = 1024, (0, 511, 1023)
# min(0.95, the share that the JAX package converges on the CPU for the first
# 16 of the same draws with the same options: 7 of 16, PERF.md)
CP_MIN_CONVERGED = 0.4375


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

    from ctdirect_tpu_torch.solver import cr_kernel
    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes

    results = {}
    cases = [(torch.float32, P_TICK, BS_TICK, WB_TICK, B), (torch.float64, P_TICK, BS_TICK, WB_TICK, B),
             (torch.float64, P_CP, BS_CP, WB_CP, CP_B)]
    for dtype, P, bs, wb, nb in cases:
        chain = random_chain(P, bs, wb, nb, dtype)
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
        resid = max(relative_residual(chain, X, xb, lane) for lane in (0, 7, nb - 1))
        if not resid < RESID_TOL[dtype]:
            raise AssertionError(f"kernel {dtype}: dense residual {resid:.3e}")
        ms = median_ms(lambda: kernel(*chain))
        plain_ms = median_ms(lambda: cr_solve_lanes(*chain))
        cap = cr_kernel.cap(bs, wb)
        log(f"CR kernel {dtype} at P={P} bs={bs} wb={wb} B={nb} (CAP={cap}): max abs err "
            f"{err:.3e} vs plain, dense residual {resid:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"(CUDA events, median of 20)")
        results.setdefault(dtype, []).append(
            dict(P=P, bs=bs, wb=wb, B=nb, cap=cap, max_abs_err=err, ms=ms, plain_ms=plain_ms))
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

    kernel.reset_counts()
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
    launches, by_cap = kernel.launches, dict(kernel.launches_by_cap)

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
    return dict(path=path_record("mpc_tick_double_integrator", launches, by_cap), u0=u0, ctrl=ctrl,
                states=states)


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


def path_record(path, launches, by_cap):
    """One main path's launches and the kernel instantiation that ran them."""
    caps = [cap for cap, count in by_cap.items() if count]
    if len(caps) != 1 or by_cap[caps[0]] != launches:
        raise AssertionError(f"{path}: launches {launches} split over instantiations as {by_cap}")
    return dict(path=path, launches=launches, cap=caps[0])


def phase_front_door_default(ct, get_problem, device="cuda"):
    """ct.solve with no scheme= (midpoint, the default) against the oracles."""
    t0 = time.perf_counter()
    sol = ct.solve(get_problem("double_integrator_minenergy").ocp, grid_size=N, tol=1e-8, device=device)
    secs = time.perf_counter() - t0
    if not sol.successful:
        raise AssertionError(f"default-scheme front door: {sol.message}")
    t = sol.time_grid
    tm = 0.5 * (t[:-1] + t[1:])  # midpoint controls live at the step midpoints
    u = sol.control_values[:-1, 0]
    if not np.max(np.abs(u - (6 - 12 * tm))) < 5e-3:
        raise AssertionError("default-scheme front door: control error")
    np.testing.assert_allclose(sol.objective, 12.0, rtol=1e-2)
    Pc = sol.costate_values
    np.testing.assert_allclose(Pc[:-1, 0], 24.0, rtol=1e-2)
    np.testing.assert_allclose(Pc[:-1, 1], 12 - 24 * tm, rtol=1e-2, atol=0.05)
    log(f"front door, default scheme (midpoint): solve N={N} on {device}: status "
        f"{sol.status}, {sol.iterations} iterations, objective {sol.objective:.10g}, p(0) = {Pc[0]}, "
        f"{secs:.2f} s wall")


def cartpole_x0(rng, batch):
    """Measured initial states around the hanging rest position
    (benchmarks/mpc_cartpole.py)."""
    return 0.02 * rng.standard_normal((batch, 4)) * np.array([1.0, 1.0, 0.5, 0.5])


def phase_cartpole_tick(ct, get_problem, kernel, device="cuda"):
    from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state

    prob = get_problem("cartpole")
    docp = ct.transcribe(prob.ocp, grid_size=CP_N, scheme="trapeze", device=device)
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1, 2, 3], resolve_iters=ITERS, kkt_algorithm="cr",
                         device=device)
    t0 = time.perf_counter()
    warm = ctrl.cold_start(options=ct.IPMOptions(tol=1e-8, max_iter=200), init=prob.init)
    cold_s = time.perf_counter() - t0
    states = broadcast_state(warm, CP_B)
    rng = np.random.default_rng(0)
    xs = [torch.tensor(cartpole_x0(rng, CP_B), dtype=torch.float64, device=device)
          for _ in range(CP_WARMUP + CP_TICKS)]

    kernel.reset_counts()
    tick_ms, kkt_max, viol_max = [], 0.0, 0.0
    for k, x0 in enumerate(xs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        states, u0, kkt, viol = ctrl(states, x0)
        end.record()
        end.synchronize()
        if k >= CP_WARMUP:
            tick_ms.append(start.elapsed_time(end))
        kkt_max, viol_max = max(kkt_max, kkt.max().item()), max(viol_max, viol.max().item())
    launches, by_cap = kernel.launches, dict(kernel.launches_by_cap)

    if launches != len(xs) * ITERS:
        raise AssertionError(f"cart-pole tick: kernel launched {launches} times, want {len(xs) * ITERS}")
    if u0.shape != (CP_B, 1) or not torch.isfinite(u0).all():
        raise AssertionError(f"cart-pole tick: u0 not finite or wrong shape {tuple(u0.shape)}")
    if not u0.abs().max().item() <= CP_UMAX * (1 + 1e-6):
        raise AssertionError(f"cart-pole tick: |u0| {u0.abs().max().item():.6g} beyond the force box")
    u_all = states.z[:, docp.control_col_indices()]
    sat = (torch.abs(u_all.abs() - CP_UMAX) < 1e-6).double().mean().item()
    p50, p90 = np.percentile(tick_ms, 50), np.percentile(tick_ms, 90)
    log(f"cart-pole tick, f64 block solve: cold start {cold_s:.2f} s; {len(xs)} ticks x B={CP_B} N={CP_N} "
        f"x {ITERS} Newton steps; tick {p50:.3f} ms p50 / {p90:.3f} ms p90 (CUDA events, {CP_TICKS} timed) "
        f"-> {CP_B / (p50 / 1e3):.1f} solves/s; max KKT {kkt_max:.3e}, max violation {viol_max:.3e}, "
        f"saturated force nodes {100 * sat:.2f}%; kernel launches {launches} {by_cap}")
    return dict(path=path_record("mpc_tick_cartpole", launches, by_cap), docp=docp, warm=warm)


def phase_cartpole_batch(ct, kernel, docp, warm, device="cuda"):
    """BatchSolver over per-instance x0 scenarios from the cold-start solution."""
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.solver.interface import _get_solver

    opts = ct.IPMOptions(tol=1e-6, max_iter=30, lsq_lambda_init=False, kkt_mode="cr")
    solver = BatchSolver(docp, opts, device=device)
    rows = docp.boundary_row_indices()[:4]
    x0 = cartpole_x0(np.random.default_rng(0), CP_BATCH)
    cl, cu = np.tile(docp._c_lb, (CP_BATCH, 1)), np.tile(docp._c_ub, (CP_BATCH, 1))
    cl[:, rows] += x0
    cu[:, rows] += x0
    z0 = warm.z.expand(CP_BATCH, -1)

    kernel.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver(z0, cl, cu)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_cap = kernel.launches, dict(kernel.launches_by_cap)
    st = solver.stats

    if launches != st.kkt_solves:
        raise AssertionError(f"batch solve: kernel launched {launches} times, {st.kkt_solves} batched KKT solves")
    if res.z.shape != (CP_BATCH, docp.nz) or not torch.isfinite(res.z).all():
        raise AssertionError("batch solve: z not finite or wrong shape")
    ok = res.successful.double().mean().item()
    its = res.iterations.cpu().numpy()
    if not ok >= CP_MIN_CONVERGED:
        raise AssertionError(f"batch solve: converged share {ok:.4f} < {CP_MIN_CONVERGED}")
    log(f"cart-pole batch solve, f64 cr: B={CP_BATCH} N={CP_N} tol {opts.tol:g}, <= {opts.max_iter} iterations: "
        f"{wall:.3f} s wall -> {CP_BATCH / wall:.1f} solves/s; converged {100 * ok:.2f}%, median iterations "
        f"{np.median(its):.0f} (max {its.max()}); {st.iterations} batch iterations, {st.kkt_solves} batched KKT "
        f"solves, {st.host_syncs} host syncs ({st.host_syncs / max(st.iterations, 1):.2f} per iteration); "
        f"kernel launches {launches} {by_cap}")

    run = _get_solver(docp, opts)
    for b in CP_CHECK:
        r, _ = run(warm.z, docp._z_lb, docp._z_ub, cl[b], cu[b])
        same = int(r.status) == int(res.status[b]) and int(r.iterations) == int(res.iterations[b])
        rel = abs(float(r.objective) - float(res.objective[b])) / max(1.0, abs(float(r.objective)))
        if not (same and rel <= 1e-8):
            raise AssertionError(
                f"batch solve: instance {b} batched (status {int(res.status[b])}, {int(res.iterations[b])} it, "
                f"objective {float(res.objective[b])!r}) vs unbatched (status {int(r.status)}, "
                f"{int(r.iterations)} it, objective {float(r.objective)!r})")
        log(f"  instance {b}: status {int(r.status)}, {int(r.iterations)} iterations, objective "
            f"{float(r.objective):.12g} batched and unbatched (rel diff {rel:.1e})")
    return dict(path=path_record("batch_solve_cartpole", launches, by_cap))


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

    phase_front_door_default(ct, get_problem)
    tick = phase_cartpole_tick(ct, get_problem, kernel)
    batch = phase_cartpole_batch(ct, kernel, tick["docp"], tick["warm"])

    paths = {
        torch.float32: [main[torch.float32]["path"]],
        torch.float64: [main[torch.float64]["path"], tick["path"], batch["path"]],
    }
    kernels = [
        dict(name=f"cr_solve_{tag}", route="cuda", source="ctdirect_tpu_torch/csrc/cr_solve.cu",
             replaces="ctdirect_tpu/solver/pallas_cr.py:281",
             launches=sum(p["launches"] for p in paths[dt]), paths=paths[dt],
             max_abs_err=max(r["max_abs_err"] for r in kres[dt]), ms=kres[dt][0]["ms"],
             plain_ms=kres[dt][0]["plain_ms"], shapes=kres[dt])
        for tag, dt in (("f32", torch.float32), ("f64", torch.float64))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
