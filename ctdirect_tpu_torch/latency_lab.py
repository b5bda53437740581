"""Single-solve latency lab on the card: the compiled full-IPM solve of one
DOCP across KKT configurations. The port's counterpart of
benchmarks/latency_lab.py.

    python -m ctdirect_tpu_torch.latency_lab [--problems beam,goddard] [--grids 250,1000,5000]
        [--configs structured:f64,cr:f64,cr:f32,structured:f32] [--tol 1e-6] [--max-iter 500]
        [--reps 3] [--jax-objectives PATH] [--json PATH] [--cpu]

A config is kkt_mode x the block solve's dtype, as in the reference:
"structured" is the sequential block elimination (O(N) depth; the scan
kernel on the card, csrc/scan_solve.cu), "cr" the cyclic reduction (O(log
N) depth; the CR kernel), "f32" the block solve in float32 inside the f64
Newton loop (IPMOptions' refinement and Ruiz defaults). Options: tol,
max_iter, kkt_mode and kkt_solve_dtype, the rest at their defaults, as the
reference sets them. For each problem and N, one trapeze DOCP; for each
config a first `solve_docp` (on the card it captures the solve's segment
graphs) and --reps more (replays), then `release_solvers()`.

A row (one JSON line each): problem, N, mode, dtype, bs, wb; ok
(successful and the objective within 1e-2 of the fixture's,
benchmarks/latency_lab.py:75-78), status, iters, obj; first_s (the first
call's wall, the reference's cold_s), warm_s (the minimum of the replays'
walls; host clock around work that ends in a synchronize) and per_iter_ms;
block_solves of a replay and warmup_block_solves of the first call, and the
kernel launches of each (the scan kernel's under "structured", the CR
kernel's under "cr"; 0 on the CPU); capture_s, captures (segment graphs),
pool_mib and host syncs per iteration; jax_status, jax_obj and jax_gap
(relative) where the JAX package's solve under the same options is known
(JAX_CPU, or a --jax-objectives file written by tools/latency_lab_jax.py on
the CPU); the card's name and power limit.
Checks (listed in a row's `failed`; the exit code says whether every row
passed): every replay equal to the first call in status, iterations and
objective, bit for bit; on the card, the config's kernel launched once per
block solve (the warm-ups' included) and the other kernel never; where the
JAX package's solve is known, the same status (but for the cells of
STATUS_RESTS_ON_ROUNDING, whose status is reported) and, where both
converged, the objective within JAX_RTOL of its.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from ctdirect_tpu_torch.shard_timing import card_line

PROBLEMS = ("beam", "goddard")
GRIDS = (250, 1000, 5000)
CONFIGS = ("structured:f64", "cr:f64", "cr:f32", "structured:f32")
TOL, MAX_ITER = 1e-6, 500
# the JAX package's solves under the lab's options on the CPU, f64 problem
# data: (status, objective) per (problem, N, config), from `JAX_PLATFORMS=cpu
# python tools/latency_lab_jax.py --grids 250,1000,5000 --json ...` (its
# iterations there: PERF.md)
JAX_CPU = {
    ("beam", 250, "structured:f64"): (0, 8.890454341855648),
    ("beam", 250, "cr:f64"): (0, 8.890454341850003),
    ("beam", 250, "cr:f32"): (0, 8.890454341721773),
    ("beam", 250, "structured:f32"): (0, 8.890454341855577),
    ("beam", 1000, "structured:f64"): (0, 8.888987063170168),
    ("beam", 1000, "cr:f64"): (0, 8.888986958614387),
    ("beam", 1000, "cr:f32"): (0, 8.888985636176697),
    ("beam", 1000, "structured:f32"): (0, 8.88898704820442),
    ("beam", 5000, "structured:f64"): (0, 8.888891637214115),
    ("beam", 5000, "cr:f64"): (0, 8.888891660766014),
    ("beam", 5000, "cr:f32"): (0, 8.888892931260362),
    ("beam", 5000, "structured:f32"): (0, 8.888892774602045),
    ("goddard", 250, "structured:f64"): (0, 1.012574697772128),
    ("goddard", 250, "cr:f64"): (0, 1.012574697772128),
    ("goddard", 250, "cr:f32"): (0, 1.0125746977721992),
    ("goddard", 250, "structured:f32"): (1, 1.0119370794812845),
    ("goddard", 1000, "structured:f64"): (0, 1.0125727291923594),
    ("goddard", 1000, "cr:f64"): (0, 1.0125727291923596),
    ("goddard", 1000, "cr:f32"): (0, 1.0125730589996829),
    ("goddard", 1000, "structured:f32"): (0, 1.0125729285978853),
    ("goddard", 5000, "structured:f64"): (0, 1.0125596132373804),
    ("goddard", 5000, "cr:f64"): (0, 1.0125596132373806),
    ("goddard", 5000, "cr:f32"): (0, 1.0125561676811352),
    # (from the guess; of the 8 draws from it moved by k = 0, +-1, +-2, +-3,
    # +4 ulps the JAX package fails 5, the card's scan kernel 2:
    # tools/rounding_witness.py, PERF.md section 6)
    ("goddard", 5000, "structured:f32"): (0, 1.0125539498056622),
}
# cells whose status rests on rounding in the JAX package itself: its solve
# from the fixture's guess with every entry moved by 1 or 2 ulps
# (tools/latency_lab_jax.py --ulps) ends with another status. goddard
# structured:f32 at N=250: status 1 (500 iterations) from the guess, 0 at
# +1 and -1 ulp (273, 323 iterations) (PERF.md). Its status is reported and
# not held; the objective is held where both converged. Where the JAX
# package and the card both converge from the guess, the status is held,
# though moved draws fail in both: at N=1000 the JAX package stalls at +1
# and +2 ulps; at N=5000 it converges at 0 and +-1 ulp and fails at +-2, +-3
# and +4 (5 of 8), the card's scan kernel at -2 and +4 (2 of 8), which a
# Fisher exact test (p = 0.31, tools/rounding_witness.py) cannot tell apart:
# rounding, not a fault of the card (PERF.md section 6).
STATUS_RESTS_ON_ROUNDING = {("goddard", 250, "structured:f32")}
# the bound on the objective's gap to the JAX package's where both
# converged (goddard: PERF.md section 2, its converged variants spread
# 3.9e-5 in the JAX package at large N)
JAX_RTOL = {"goddard": 1e-4}
JAX_RTOL_DEFAULT = 1e-6


def log(msg):
    print(msg, flush=True)


def options(cfg: str, tol=TOL, max_iter=MAX_ITER) -> dict:
    """The IPMOptions fields of a config "mode:dtype" (benchmarks/latency_lab.py:63-68)."""
    mode, dt = cfg.split(":")
    return dict(tol=tol, max_iter=max_iter, kkt_mode=mode, kkt_solve_dtype=None if dt == "f64" else dt)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernels():
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched
    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched

    return {"structured": scan_solve_batched, "cr": cr_solve_batched}


def _call(fn, dev):
    """fn(): (its result, host wall s, the launches it added per kernel)."""
    kernels = _kernels()
    before = {m: k.launches for m, k in kernels.items()}
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    return out, wall, {m: k.launches - before[m] for m, k in kernels.items()}


def run_config(docp, prob, name, N, cfg, reps=3, tol=TOL, max_iter=MAX_ITER, jax_ref=None) -> dict:
    """One config on one DOCP: a first solve_docp and `reps` more, checked
    (see the module docstring); returns its row."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    dev = docp.device
    card = dev.type == "cuda"
    mode, dt = cfg.split(":")
    opts = ct.IPMOptions(**options(cfg, tol, max_iter))
    run = _get_solver(docp, opts)
    row = dict(problem=name, N=N, mode=mode, dtype=dt, bs=run.kkt.d.bs, wb=run.kkt.d.wb, device=str(dev))
    failed = []
    try:
        calls = []
        for _ in range(1 + reps):
            run.stats = BatchStats()
            sol, wall, launches = _call(lambda: ct.solve_docp(docp, init=prob.init, options=opts), dev)
            calls.append((sol, wall, launches, run.stats))
        (first, first_s, first_launches, _), replays = calls[0], calls[1:]
        last, _, last_launches, st = calls[-1]
        warm_s = min(c[1] for c in replays) if replays else float("nan")
        ok = bool(first.successful) and (prob.obj is None or abs(first.objective - prob.obj) <= 1e-2 * abs(prob.obj))
        row.update(ok=ok, status=first.status, iters=first.iterations, obj=float(first.objective), first_s=first_s,
                   warm_s=warm_s, warm_all=[c[1] for c in replays],
                   per_iter_ms=1e3 * warm_s / max(first.iterations, 1),
                   block_solves=last.infos["kkt_block_solves"],
                   warmup_block_solves=first.infos["kkt_warmup_block_solves"],
                   launches_first=first_launches[mode], launches=last_launches[mode],
                   capture_s=first.infos.get("capture_s", 0.0), captures=first.infos.get("captures", 0),
                   pool_mib=run.graph.pool_bytes / 2**20 if card and run.graph is not None else 0.0,
                   syncs_per_iteration=st.host_syncs / st.iterations if st.iterations else None)
        for sol, *_ in replays:
            if (sol.status, sol.iterations, sol.objective) != (first.status, first.iterations, first.objective):
                failed.append(f"a replay (status {sol.status}, {sol.iterations} iterations, objective "
                              f"{sol.objective!r}) differs from the first call")
        if card:
            other = "cr" if mode == "structured" else "structured"
            for tag, (sol, _, launches, _) in zip(["first"] + ["replay"] * reps, calls):
                want = sol.infos["kkt_block_solves"] + sol.infos["kkt_warmup_block_solves"]
                if launches[mode] != want or launches[other]:
                    failed.append(f"{tag} call: {launches[mode]} {mode} kernel launches and {launches[other]} "
                                  f"{other} for {want} block solves (warm-ups included)")
        if jax_ref is not None:
            status, obj = jax_ref
            rtol = JAX_RTOL.get(name, JAX_RTOL_DEFAULT)
            gap = abs(first.objective - obj) / abs(obj)
            row.update(jax_status=status, jax_obj=obj, jax_gap=gap, jax_rtol=rtol)
            if (name, N, cfg) in STATUS_RESTS_ON_ROUNDING:
                row["status_rests_on_rounding"] = True
            if first.status != status and not row.get("status_rests_on_rounding"):
                failed.append(f"status {first.status}, the JAX package's {status}")
            elif first.status == status == 0 and not gap <= rtol:
                failed.append(f"objective {first.objective!r} is {gap:.3e} from the JAX package's {obj!r} "
                              f"(bound {rtol:g})")
    except Exception as e:  # noqa: BLE001 -- the lab goes on (benchmarks/latency_lab.py:86-88)
        row.update(ok=False, error=f"{type(e).__name__}: {e}"[:400])
        failed.append("raised")
    finally:
        docp.release_solvers()
    row["failed"] = failed
    return row


def run_lab(problems=PROBLEMS, grids=GRIDS, configs=CONFIGS, device="cuda", reps=3, tol=TOL, max_iter=MAX_ITER,
            jax=None, log=log) -> list:
    """run_config over problems x grids x configs (one DOCP per problem and
    N); `jax` maps (problem, N, config) to the JAX package's (status,
    objective), by default JAX_CPU. Prints and returns the rows."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    jax = JAX_CPU if jax is None else jax
    card = "cpu" if torch.device(device).type == "cpu" else card_line()
    rows = []
    for name in problems:
        prob = get_problem(name)
        for N in grids:
            docp = ct.transcribe(prob.ocp, grid_size=N, scheme="trapeze", device=device)
            for cfg in configs:
                row = run_config(docp, prob, name, N, cfg, reps=reps, tol=tol, max_iter=max_iter,
                                 jax_ref=jax.get((name, N, cfg)))
                row["card"] = card
                rows.append(row)
                log(json.dumps(row))
            del docp
            gc.collect()
    return rows


def report(rows, log=log) -> dict:
    """The rows as a table; returns `ok` (no row failed a check) and the
    failed rows."""
    log(f"{'problem':>8} {'N':>5} {'config':>15} {'ok':>3} {'st':>3} {'iters':>5} {'first_s':>8} {'warm_s':>8} "
        f"{'ms/it':>7} {'solves':>6} {'launch':>6} {'capture':>7} {'pool':>6} {'jax_gap':>9}")
    for r in rows:
        if "error" in r:
            log(f"{r['problem']:>8} {r['N']:>5} {r['mode'] + ':' + r['dtype']:>15} ERROR {r['error']}")
            continue
        gap = f"{r['jax_gap']:.2e}" if "jax_gap" in r else "-"
        gap += " (JAX status %d; rests on rounding)" % r["jax_status"] if r.get("status_rests_on_rounding") else ""
        log(f"{r['problem']:>8} {r['N']:>5} {r['mode'] + ':' + r['dtype']:>15} {'y' if r['ok'] else 'n':>3} "
            f"{r['status']:>3} {r['iters']:>5} {r['first_s']:>8.3f} {r['warm_s']:>8.4f} {r['per_iter_ms']:>7.2f} "
            f"{r['block_solves']:>6} {r['launches']:>6} {r['capture_s']:>7.3f} {r['pool_mib']:>6.1f} {gap:>9}")
    bad = [r for r in rows if r["failed"]]
    for r in bad:
        log(f"  FAILED {r['problem']} N={r['N']} {r['mode']}:{r['dtype']}: {'; '.join(r['failed'])}")
    return dict(ok=not bad and bool(rows), bad=[(r["problem"], r["N"], f"{r['mode']}:{r['dtype']}") for r in bad])


def read_jax(path) -> dict:
    """A tools/latency_lab_jax.py file as {(problem, N, config): (status, objective)}."""
    out = {}
    for key, v in json.loads(Path(path).read_text()).items():
        name, N, cfg = key.split(" ")
        out[name, int(N), cfg] = (v["status"], v["objective"])
    return out


def warm_up(device, log=log):
    """Both kernels built and loaded, and one compiled solve of each mode
    at N=10: the process's first-use costs are not the first row's."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    t0 = time.perf_counter()
    builds = {m: k.library()[1] for m, k in _kernels().items()}
    for mode in ("structured", "cr"):
        ct.solve(get_problem("beam").ocp, grid_size=10, scheme="trapeze", device=device,
                 options=ct.IPMOptions(kkt_mode=mode))
    torch.cuda.synchronize(device)
    log(f"warm-up: {time.perf_counter() - t0:.3f} s (kernel builds {builds} s, a compiled solve of beam at N=10 "
        f"per mode)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="single-solve latency across KKT configurations")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the card)")
    parser.add_argument("--problems", default=",".join(PROBLEMS))
    parser.add_argument("--grids", default=",".join(map(str, GRIDS)))
    parser.add_argument("--configs", default=",".join(CONFIGS))
    parser.add_argument("--tol", type=float, default=TOL)
    parser.add_argument("--max-iter", type=int, default=MAX_ITER)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--jax-objectives", help="a tools/latency_lab_jax.py file (else the stored JAX_CPU)")
    parser.add_argument("--json", help="also write the rows here")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("latency_lab: no CUDA device (--cpu runs on the CPU)", file=sys.stderr)
        return 1
    device = "cpu" if args.cpu else "cuda"
    jax = {**JAX_CPU, **read_jax(args.jax_objectives)} if args.jax_objectives else JAX_CPU
    if device == "cuda":
        log(card_line())
        warm_up(device)
    t0 = time.perf_counter()
    rows = run_lab(args.problems.split(","), [int(g) for g in args.grids.split(",")], args.configs.split(","),
                   device=device, reps=args.reps, tol=args.tol, max_iter=args.max_iter, jax=jax)
    summary = report(rows)
    if args.json:
        Path(args.json).write_text(json.dumps(dict(rows=rows, torch=torch.__version__,
                                                   wall_s=time.perf_counter() - t0)) + "\n")
        log(f"wrote {args.json}")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
