"""The headline bench on the card: warm-started MPC solves/s of the double
integrator at N=100, trapeze. The port's counterpart of bench.py.

    python -m ctdirect_tpu_torch.bench [--cpu] [--json PATH] [--split]

It reads the reference's environment names, with the same meanings:
BENCH_N (100), BENCH_BATCH (512), BENCH_ITERS (3 Newton steps a tick),
BENCH_ALGO ("cr"; or "scan"), BENCH_SOLVE_F32 ("0": the block solve in f64;
else f32 inside the f64 Newton loop), BENCH_ASM_F32 ("1": prepare and
assembly in f32 too), BENCH_REPS (30) and BENCH_F32 ("1": the whole tick in
float32, as the reference's CTDIRECT_TPU_X64=0). It refuses BENCH_PIVOT=0
(the pivotless Gauss-Jordan gives a NaN KKT on this tick, so the port has
none) and any BENCH_LOOP but "unroll" (the reference's choice of XLA
program size; every loop computes the same iteration).

What it runs, in the reference's order (`run`):
  1. double_integrator_minenergy transcribed at N steps (trapeze) and
     MPCController(x0_boundary_rows=[0, 1], resolve_iters=ITERS,
     kkt_algorithm=ALGO, the block solve's and the assembly's dtypes);
  2. the cold start, IPMOptions(tol=1e-8, max_iter=60) (the default
     structured block solve: on the card a compiled solve on the scan
     kernel): cold_start_s;
  3. the warm state tiled over B; x0 from default_rng(0): one (B, 2) draw
     for the first tick, then one a tick for REPS ticks, each 0.03 N(0, 1);
  4. the first tick (on the card: a warm-up tick, the capture of its CUDA
     graph, a replay): tick_compile_s;
  5. REPS ticks in pipelined batches of 10, one synchronize a batch, host
     clock: tick_ms_p50 / p90 across batches and value = B / p50;
  6. the same REPS x0s again, a synchronize after each tick: the host
     clock's tick_ms_synced_p50, and CUDA events around each tick on the
     card (tick_ms_event_p50 / p90);
  7. 5 ticks over the first x0s, the replayed tick and the eager tick
     (MPCController.eager) from the state the timed ticks left;
  8. with --split, the eager tick's device ms by stage over 5 ticks
     (utils/profiling.py::tick_stage_split; the card only).
Its kernels' counts are set to 0 just before step 5 and read just after
step 6: the block-solve kernel of ALGO (the CR kernel under "cr") launches
ITERS times a tick, the other none; the cold start's structured block
solves each launch the scan kernel once.

Checks (`report`; a failed one makes the script exit non-zero, after it has
printed the JSON line): u0 finite and of shape (B, 1); the max KKT over
every tick below KKT_LIMIT where the Newton loop is f64 (under BENCH_F32 it
is reported, not held); the replay within GRAPH_TOL of the eager tick (u0
and KKT at each tick, the states after the last); on the card the launch
counts above.

The roofline (`roofline`) is the counterpart of
benchmarks/profile_tick.py::roofline, whose XLA cost analysis PyTorch has
no counterpart of. It counts a LOWER bound of the tick's work: per Newton
step, the block solve's inputs read once and its outputs written once and
the operations the solve needs (`cr_kernel.solve_cost`, or
`scan_kernel.solve_cost` under "scan", at the chain the operator hands
the kernel), and once a tick the warm state and x0 read and the new state,
u0, KKT and violation written. It leaves out the KKT operator's prepare
(the derivatives of the dynamics and costs), the assembly of the chain,
the Newton update and every byte read twice, so hbm_util =
achieved_gbps / 3,350 GB/s cannot exceed 1; bound_ms = max(bytes / 3.35
TB/s, flops / 67 TFLOP/s), NVIDIA's H100 SXM figures.

The JSON line keeps the reference's keys but for vs_baseline and
mfu_f32peak (TPU quantities), and adds the card's name and power limit
(nvidia-smi), the kernel launches a tick, the CUDA-event times, bound_ms
and the stage split. On the CPU (--cpu) the device-rate keys are null: a
CPU run gives no device figure."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ctdirect_tpu_torch.shard_timing import card_line

PROBLEM = "double_integrator_minenergy"
# the reference's defaults (bench.py:46-99)
DEFAULT_CFG = dict(N=100, B=512, iters=3, algo="cr", solve_f32=True, asm_f32=False, f32=False, reps=30)
CHUNK = 10  # ticks a pipelined batch (bench.py:101)
X0_SCALE = 0.03
COLD_OPTS = dict(tol=1e-8, max_iter=60)
KKT_LIMIT = 1e-10  # PERF.md section 2, hard where the Newton loop is f64
GRAPH_TOL = 1e-13  # the replayed tick against the eager tick (bitwise expected)
EAGER_TICKS = 5
SPLIT_TICKS = 5


def config_from_env(env=None) -> dict:
    """DEFAULT_CFG under the reference's BENCH_* environment names; raises
    ValueError for BENCH_PIVOT=0 and a BENCH_LOOP other than "unroll"."""
    env = os.environ if env is None else env
    if env.get("BENCH_PIVOT", "1") == "0":
        raise ValueError("BENCH_PIVOT=0: the port has no pivotless Gauss-Jordan (it gives a NaN KKT on this "
                         "tick; ROADMAP.md, 'Do not port')")
    if env.get("BENCH_LOOP", "unroll") != "unroll":
        raise ValueError(f"BENCH_LOOP={env['BENCH_LOOP']}: the port runs the Newton steps one way (resolve_loop is "
                         f"an XLA program-size choice of the same iteration; ROADMAP.md, 'Do not port')")
    cfg = dict(DEFAULT_CFG)
    for key, name in (("N", "BENCH_N"), ("B", "BENCH_BATCH"), ("iters", "BENCH_ITERS"), ("reps", "BENCH_REPS")):
        if name in env:
            cfg[key] = int(env[name])
    cfg.update(algo=env.get("BENCH_ALGO", cfg["algo"]), solve_f32=env.get("BENCH_SOLVE_F32") != "0",
               asm_f32=env.get("BENCH_ASM_F32") == "1", f32=env.get("BENCH_F32") == "1")
    return cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def roofline(cfg, ctrl, states, p50_ms=None) -> dict:
    """The tick's lower-bound work (module docstring) for controller `ctrl`
    ticking the batched warm state `states`: bytes, flops, bound_ms and
    bound_by; with the tick's p50_ms measured on the card, the rates it
    implies too: achieved_gbps, achieved_gflops and hbm_util."""
    from ctdirect_tpu_torch.solver import cr_kernel, scan_kernel

    d, dtype = ctrl.kkt.d, ctrl.dtype
    solve_dtype = ctrl.kkt.solve_dtype or dtype
    if cfg["algo"] == "cr":  # the chain padded to a power of two
        solve = cr_kernel.solve_cost(solve_dtype, 1 << (d.N - 1).bit_length(), d.bs, d.wb, cfg["B"])
    else:
        solve = scan_kernel.solve_cost(solve_dtype, d.N, d.bs, d.wb, cfg["B"])
    itemsize = torch.finfo(dtype).bits // 8
    state = sum(a[0].numel() for a in states)
    # the warm state read and written, x0 read, u0, KKT and violation written
    once = itemsize * cfg["B"] * (2 * state + 2 + 3)
    c = cr_kernel.cost(solve_dtype, cfg["iters"] * solve.bytes + once, cfg["iters"] * solve.flops)
    out = dict(bytes=c.bytes, flops=c.flops, bound_ms=c.bound_ms, bound_by=c.bound_by)
    if p50_ms is not None:
        s = p50_ms / 1e3
        out.update(achieved_gbps=c.bytes / s / 1e9, achieved_gflops=c.flops / s / 1e9,
                   hbm_util=c.bytes / s / cr_kernel.PEAK_BYTES_S)
    return out


def tick_run(tick, states, xs, warmup=0) -> dict:
    """xs through `tick` from `states`, a synchronize after each tick, each
    timed (but the first `warmup`) on the host clock and, on a card, by
    CUDA events (`host_ms`, `tick_ms`); every tick's u0 and KKT, the last
    states and violation, and the max KKT."""
    cuda = states.z.device.type == "cuda"
    tick_ms, host_ms, u0s, kkts = [], [], [], []
    for k, x0 in enumerate(xs):
        h0 = time.perf_counter()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        states, u0, kkt, viol = tick(states, x0)
        if cuda:
            end.record()
            end.synchronize()
        if k >= warmup:
            host_ms.append((time.perf_counter() - h0) * 1e3)
            if cuda:
                tick_ms.append(start.elapsed_time(end))
        u0s.append(u0)
        kkts.append(kkt)
    return dict(states=states, u0s=u0s, kkts=kkts, tick_ms=tick_ms, host_ms=host_ms,
                kkt_max=max(k.max().item() for k in kkts), viol=viol)


def _max_diff(xs, ys) -> float:
    return max((a.double() - b.double()).abs().max().item() for a, b in zip(xs, ys))


def run(cfg: dict, *, device, split: bool = False, log=None) -> dict:
    """The measurements of `cfg` (DEFAULT_CFG's keys) on `device`; `report`
    checks them and makes the JSON line. Besides the line's numbers it
    keeps every tick's u0 and KKT (numpy), the cold start's warm state and
    the launch counts."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched as scan

    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    dev = torch.device(device)
    B, N, iters, reps = cfg["B"], cfg["N"], cfg["iters"], cfg["reps"]
    dtype = torch.float32 if cfg["f32"] else torch.float64
    solve_dtype = torch.float32 if cfg["solve_f32"] else None
    out = dict(cfg=dict(cfg), device=str(dev), card=card_line() if dev.type == "cuda" else "cpu",
               dtype=str(dtype).replace("torch.", ""))
    docp = ct.transcribe(get_problem(PROBLEM).ocp, grid_size=N, scheme="trapeze", device=dev, dtype=dtype)

    def make_ctrl():
        return MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=iters, kkt_algorithm=cfg["algo"],
                             kkt_solve_dtype=solve_dtype,
                             kkt_assemble_dtype=torch.float32 if cfg["asm_f32"] else None, device=dev, dtype=dtype)

    ctrl = make_ctrl()
    out["kkt_solve_dtype"] = "f32" if (ctrl.kkt.solve_dtype or dtype) == torch.float32 else "f64"

    cold_opts = ct.IPMOptions(**COLD_OPTS)
    scan.reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    warm = ctrl.cold_start(options=cold_opts)
    _sync(dev)
    out["cold_start_s"] = time.perf_counter() - t0
    out["cold"] = dict(block_solves=_get_solver(docp, cold_opts).kkt.block_solves, scan_launches=scan.launches)
    out["warm"] = {f: getattr(warm, f).cpu().numpy() for f in warm._fields}
    log(f"cold start (a full IPM, tol {COLD_OPTS['tol']:g}): {out['cold_start_s']:.3f} s, "
        f"{out['cold']['block_solves']} structured block solves, scan kernel launches {scan.launches}")

    states = broadcast_state(warm, B)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(X0_SCALE * rng.standard_normal((B, 2)), dtype=dtype, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    states, u0, kkt, _ = ctrl(states, x0)
    _sync(dev)
    out["tick_compile_s"] = time.perf_counter() - t0
    out["captures"] = ctrl.captures
    u0s, kkts = [u0], [kkt]
    log(f"first tick (warm-up, capture, replay on a card): {out['tick_compile_s']:.3f} s, {ctrl.captures} "
        f"capture(s)")

    xs = [torch.tensor(X0_SCALE * rng.standard_normal((B, 2)), dtype=dtype, device=dev) for _ in range(reps)]
    kernel.reset_counts()
    scan.reset_counts()
    batch_ms = []
    for k0 in range(0, reps, CHUNK):
        chunk = xs[k0:k0 + CHUNK]
        _sync(dev)
        t0 = time.perf_counter()
        for x in chunk:
            states, u0, kkt, _ = ctrl(states, x)
            u0s.append(u0)
            kkts.append(kkt)
        _sync(dev)
        batch_ms.append((time.perf_counter() - t0) / len(chunk) * 1e3)
    synced = tick_run(ctrl, states, xs)
    out["counts"] = dict(ticks=2 * reps, cr_launches=kernel.launches, cr_grid_launches=kernel.grid_launches,
                         scan_launches=scan.launches)
    states = synced["states"]
    u0s += synced["u0s"]
    kkts += synced["kkts"]
    out.update(batch_ms=batch_ms, tick_ms_p50=float(np.percentile(batch_ms, 50)),
               tick_ms_p90=float(np.percentile(batch_ms, 90)),
               tick_ms_synced_p50=float(np.percentile(synced["host_ms"], 50)))
    if synced["tick_ms"]:
        out.update(tick_ms_event_p50=float(np.percentile(synced["tick_ms"], 50)),
                   tick_ms_event_p90=float(np.percentile(synced["tick_ms"], 90)))

    ticks = {tag: tick_run(fn, states, xs[:EAGER_TICKS]) for tag, fn in (("eager", ctrl.eager), ("replay", ctrl))}
    e, r = ticks["eager"], ticks["replay"]
    out["replay_vs_eager"] = dict(u0=_max_diff(r["u0s"], e["u0s"]), kkt=_max_diff(r["kkts"], e["kkts"]),
                                  states=_max_diff(r["states"], e["states"]))
    out["bitwise"] = all(torch.equal(a, b) for a, b in zip((*r["u0s"], *r["kkts"], *r["states"]),
                                                           (*e["u0s"], *e["kkts"], *e["states"])))
    out["u0_shape"], out["u0_finite"] = tuple(u0s[-1].shape), bool(torch.isfinite(u0s[-1]).all())
    out["u0s"] = [a.cpu().numpy() for a in u0s]
    out["kkts"] = [a.cpu().numpy() for a in kkts]
    out["kkt_max"] = float(max(k.max() for k in out["kkts"]))
    out["roofline"] = roofline(cfg, ctrl, states, out["tick_ms_p50"] if dev.type == "cuda" else None)
    if split and dev.type == "cuda":
        from ctdirect_tpu_torch.utils.profiling import tick_stage_split

        out["stage_ms"] = tick_stage_split(make_ctrl, states, xs, SPLIT_TICKS)
    docp.release_solvers()
    return out


def report(result: dict, log=None) -> tuple:
    """(the JSON line as a dict, the failed checks) of a `run` result; logs
    a summary line and each failed check."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cfg, cuda = result["cfg"], result["device"].startswith("cuda")
    B, iters, counts = cfg["B"], cfg["iters"], result["counts"]
    failed = []
    if result["u0_shape"] != (B, 1) or not result["u0_finite"]:
        failed.append(f"u0 of shape {result['u0_shape']}, finite {result['u0_finite']}")
    held = result["dtype"] == "float64"
    if held and not result["kkt_max"] < KKT_LIMIT:
        failed.append(f"max KKT {result['kkt_max']:.3e} >= {KKT_LIMIT:g}")
    diff = max(result["replay_vs_eager"].values())
    if not diff <= GRAPH_TOL:
        failed.append(f"the replayed tick differs from the eager tick by {result['replay_vs_eager']} > {GRAPH_TOL:g}")
    per_tick = dict(cr=None, scan=None)
    if cuda:
        mine, other = ("cr_launches", "scan_launches") if cfg["algo"] == "cr" else ("scan_launches", "cr_launches")
        want = counts["ticks"] * iters
        if counts[mine] != want or counts[other] != 0:
            failed.append(f"{counts} over {counts['ticks']} ticks: want {want} {mine} and no {other}")
        cold = result["cold"]
        if not cold["scan_launches"] or cold["scan_launches"] != cold["block_solves"]:
            failed.append(f"cold start: {cold['scan_launches']} scan kernel launches for {cold['block_solves']} "
                          f"structured block solves")
        per_tick = {k: counts[f"{k}_launches"] / counts["ticks"] for k in per_tick}
    roof = result["roofline"]
    p50 = result["tick_ms_p50"]
    line = dict(
        metric=f"warm-start MPC solves/s/card, N={cfg['N']} trapezoid", value=B / (p50 / 1e3), unit="solves/s",
        hbm_util=roof.get("hbm_util"), achieved_gflops=roof.get("achieved_gflops"),
        achieved_gbps=roof.get("achieved_gbps"), tick_compile_s=result["tick_compile_s"],
        cold_start_s=result["cold_start_s"], kkt_solve_dtype=result["kkt_solve_dtype"], kkt_max=result["kkt_max"],
        kkt_max_held=held, tick_ms_p50=p50, tick_ms_p90=result["tick_ms_p90"],
        tick_ms_synced_p50=result["tick_ms_synced_p50"], reps=cfg["reps"],
        card=result["card"], device=result["device"], B=B, N=cfg["N"], iters=iters, algo=cfg["algo"],
        dtype=result["dtype"], cr_launches_per_tick=per_tick["cr"], scan_launches_per_tick=per_tick["scan"],
        tick_ms_event_p50=result.get("tick_ms_event_p50"), tick_ms_event_p90=result.get("tick_ms_event_p90"),
        bound_ms=roof["bound_ms"], bound_by=roof["bound_by"], bytes_per_tick=roof["bytes"],
        flops_per_tick=roof["flops"], stage_ms=result.get("stage_ms"),
        replay_vs_eager=diff, bitwise=result["bitwise"], failed=failed)
    rates = (f"; {roof['achieved_gbps']:.1f} GB/s ({100 * roof['hbm_util']:.2f}% of 3.35 TB/s), "
             f"{roof['achieved_gflops']:.1f} GFLOP/s" if "hbm_util" in roof else "")
    rates += f"; bound {roof['bound_ms']:.4f} ms ({roof['bound_by']}, {roof['bytes'] / 1e6:.2f} MB a tick)"
    events = (f", CUDA events p50 / p90 {line['tick_ms_event_p50']:.3f} / {line['tick_ms_event_p90']:.3f} ms"
              if line["tick_ms_event_p50"] is not None else "")
    log(f"B={B} N={cfg['N']} iters={iters} algo={cfg['algo']} {line['kkt_solve_dtype']} block solve on "
        f"{result['card']}: p50 {p50:.3f} ms/tick (p90 {line['tick_ms_p90']:.3f}, synced p50 "
        f"{line['tick_ms_synced_p50']:.3f}{events}) -> {line['value']:.1f} solves/s; max KKT {result['kkt_max']:.3e}"
        f"{'' if held else ' (f32 Newton loop: reported, not held)'}; replay vs eager {diff:.3e}"
        f"{' (bitwise)' if result['bitwise'] else ''}; kernel launches a tick {per_tick}{rates}")
    for what in failed:
        log(f"FAILED: {what}")
    return line, failed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the headline MPC bench: warm-start solves/s at N=100 trapeze")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the card)")
    parser.add_argument("--json", help="also write the JSON line here")
    parser.add_argument("--split", action="store_true", help="the eager tick's device ms by stage (a profile)")
    args = parser.parse_args(argv)
    try:
        cfg = config_from_env()
    except ValueError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if not args.cpu and not torch.cuda.is_available():
        print("bench: no CUDA device (--cpu runs on the CPU)", file=sys.stderr)
        return 1
    result = run(cfg, device="cpu" if args.cpu else "cuda", split=args.split)
    line, failed = report(result)
    text = json.dumps(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
