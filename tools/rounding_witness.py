"""Draws that tell a fault of the port from rounding: a solve from the
fixture's guess and from that guess with every entry moved by k ulps,
counted, and two such counts compared by a stated test.

    python tools/rounding_witness.py draws [--grid 5000] [--ulps=0,1,-1,2,-2,3,-3,4]
        [--device cuda] [--scan-source PATH] [--max-iter 500] [--deadline SECONDS]
        [--json PATH]
    python tools/rounding_witness.py compare A_FILE B_FILE

(`--ulps=` with the "=": a list that starts with a minus sign is no option.)
`draws` runs the port's latency-lab cell goddard `structured:f32`
(ctdirect_tpu_torch/latency_lab.py: trapeze, IPMOptions(tol=1e-6, max_iter,
kkt_mode="structured", kkt_solve_dtype="f32"), Ruiz and refinement at their
defaults) on one DOCP, one `solve_docp` a draw, the
guess z0 moved as tools/latency_lab_jax.py --ulps moves it: z0 * (1 + k *
2**-52). On a card the solves are compiled as the lab runs them (the first
draw captures the segment graphs, the others replay them). It prints one
JSON line a draw: k, status, iterations, objective, its gap to the JAX
package's objective (latency_lab.JAX_CPU) and whether the draw fails the
lab's check (`failed`: not converged, or converged beyond
latency_lab.JAX_RTOL of that objective), block solves, scan-kernel
launches, wall seconds. --scan-source builds the scan kernel of the cell's
block width from another source (a variant of csrc/scan_solve.cu with the
same C interface) and solves with it; --deadline starts no draw that the
longest draw so far would carry past it.

`compare` counts the failed draws in two files of JSON lines and applies
the rule below. A line is one of:
- a draw of `draws` (its `failed`);
- a line of tools/latency_lab_jax.py (the JAX package on the CPU; judged by
  the lab's check against the same objective);
- a stage of tools/ci_override_witness.py: a draw (fixture, package, block,
  ulps) fails unless its last stage holds the CI's oracle (`verdict` "");
  a draw with no last stage (cut by a deadline) is left out and counted as
  unfinished.

The rule (`fault_or_rounding`): the two arms' failure counts go into a
two-sided Fisher exact test on the 2x2 table (failed, passed) x (arm a,
arm b). A difference counts as a fault only at p < 0.05; otherwise the
cell's outcome rests on rounding and the two arms do not separate. Every
comparison of the repository's records (PERF.md, ROADMAP.md queue 3) applies
this rule the same way.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
ALPHA = 0.05
PROBLEM, CONFIG = "goddard", "structured:f32"
GODDARD_ULPS = (0, 1, -1, 2, -2, 3, -3, 4)


def _hypergeom(k, n_a, n_b, fails):
    """P(k of the `fails` failures fall in arm a) with the margins fixed."""
    return math.comb(n_a, k) * math.comb(n_b, fails - k) / math.comb(n_a + n_b, fails)


def fisher_two_sided(fails_a, n_a, fails_b, n_b) -> float:
    """The two-sided Fisher exact p-value of the table [[fails_a, n_a -
    fails_a], [fails_b, n_b - fails_b]]: the probability, with the margins
    fixed, of every table no more likely than the observed one."""
    if not (0 <= fails_a <= n_a and 0 <= fails_b <= n_b):
        raise ValueError(f"counts out of range: {fails_a}/{n_a}, {fails_b}/{n_b}")
    fails = fails_a + fails_b
    lo, hi = max(0, fails - n_b), min(n_a, fails)
    observed = _hypergeom(fails_a, n_a, n_b, fails)
    p = sum(q for q in (_hypergeom(k, n_a, n_b, fails) for k in range(lo, hi + 1)) if q <= observed * (1 + 1e-7))
    return min(1.0, p)


def fault_or_rounding(fails_a, n_a, fails_b, n_b, alpha=ALPHA) -> dict:
    """The rule of the module docstring: {"p", "verdict"}, the verdict
    "fault" where p < alpha, else "rounding"."""
    p = fisher_two_sided(fails_a, n_a, fails_b, n_b)
    return dict(p=p, verdict="fault" if p < alpha else "rounding")


def moved_guess(z0, k):
    """z0 with every entry moved by about k ulps, as tools/latency_lab_jax.py
    --ulps moves it (float64 numpy)."""
    z0 = np.asarray(z0, dtype=np.float64)
    return z0 * (1 + k * 2.0**-52) if k else z0


def _lab():
    from ctdirect_tpu_torch import latency_lab

    return latency_lab


def lab_verdict(problem, N, config, status, objective) -> tuple:
    """(gap to the JAX package's objective or None, failed) under the lab's
    check: a draw fails unless it converges (status 0) within
    latency_lab.JAX_RTOL of latency_lab.JAX_CPU's objective."""
    lab = _lab()
    ref = lab.JAX_CPU.get((problem, N, config))
    if ref is None:
        return None, status != 0
    gap = abs(objective - ref[1]) / abs(ref[1])
    return gap, not (status == 0 and gap <= lab.JAX_RTOL.get(problem, lab.JAX_RTOL_DEFAULT))


def install_scan_source(source, bs):
    """Build `source` as the scan kernel's library of width bs and make the
    wrapper solve with it; returns (library path, build seconds)."""
    from ctdirect_tpu_torch.solver import cr_kernel, scan_kernel

    key = scan_kernel.width_key(bs)
    path, seconds, _ = cr_kernel.build(verbose=True, source=Path(source).resolve(), extra=(f"-DSCAN_WIDTH={key}",))
    scan_kernel.scan_solve_batched._libs[key] = scan_kernel._load(path)
    return path, seconds


def run_draws(grid=5000, ulps=GODDARD_ULPS, device="cuda", scan_source=None, max_iter=None,
              deadline=float("inf"), emit=print) -> list:
    """The draws of one arm (see the module docstring); returns their rows."""
    import torch

    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched

    lab = _lab()
    t_start = time.perf_counter()
    prob = get_problem(PROBLEM)
    opts = ct.IPMOptions(**lab.options(CONFIG, max_iter=lab.MAX_ITER if max_iter is None else max_iter))
    docp = ct.transcribe(prob.ocp, grid_size=grid, scheme="trapeze", device=device)
    card = docp.device.type == "cuda"
    head = dict(problem=PROBLEM, N=grid, config=CONFIG, device=str(docp.device),
                kernel=str(scan_source) if scan_source else "shipped")
    if card:
        head["card"] = lab.card_line()
        if scan_source:
            path, seconds = install_scan_source(scan_source, _get_solver(docp, opts).kkt.d.bs)
            head.update(library=path.name, build_s=seconds)
    base = np.asarray(docp.initial_guess(prob.init), dtype=np.float64)
    rows, longest = [], 0.0
    try:
        for k in ulps:
            if time.perf_counter() - t_start + longest > deadline:
                emit(json.dumps(dict(head, k=k, skipped="deadline")))
                continue
            z0 = moved_guess(base, k)
            docp.initial_guess = lambda init=None, z0=z0: z0.copy()
            launches = scan_solve_batched.launches
            t0 = time.perf_counter()
            sol = ct.solve_docp(docp, init=prob.init, options=opts)
            if card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            longest = max(longest, wall)
            gap, failed = lab_verdict(PROBLEM, grid, CONFIG, int(sol.status), float(sol.objective))
            row = dict(head, k=k, status=int(sol.status), iterations=int(sol.iterations),
                       objective=float(sol.objective), gap=gap, failed=failed,
                       block_solves=sol.infos.get("kkt_block_solves"),
                       warmup_block_solves=sol.infos.get("kkt_warmup_block_solves"),
                       launches=scan_solve_batched.launches - launches, wall_s=wall)
            rows.append(row)
            emit(json.dumps(row))
    finally:
        docp.release_solvers()
    return rows


def read_rows(path) -> list:
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rows


def outcomes(rows) -> dict:
    """{"draws": [(k, failed), ...], "unfinished": [k, ...]} of the draws in
    rows (see the module docstring for the three kinds of line)."""
    draws, unfinished, recipes = [], [], {}
    for r in rows:
        if "fixture" in r:  # tools/ci_override_witness.py
            if "ulps" not in r:
                continue
            key = (r["fixture"], r["package"], r["block"], r.get("dtv", 0), r["ulps"])
            rec = recipes.setdefault(key, dict(done=False, failed=False))
            if "error" in r:
                rec.update(done=True, failed=True)
            elif "verdict" in r:
                rec.update(done=True, failed=r["verdict"] != "")
        elif "skipped" in r:
            unfinished.append(r["k"])
        elif "failed" in r and "k" in r:  # a draw of this tool
            draws.append((r["k"], bool(r["failed"])))
        elif "config" in r and "status" in r:  # tools/latency_lab_jax.py
            _, failed = lab_verdict(r["problem"], r["N"], r["config"], r["status"], r["objective"])
            draws.append((r.get("ulps", 0), failed))
    for key, rec in recipes.items():
        (draws if rec["done"] else unfinished).append((key[-1], rec["failed"]) if rec["done"] else key[-1])
    return dict(draws=draws, unfinished=unfinished)


def compare(path_a, path_b) -> dict:
    """The failed draws of two files ("a", "b": failed/draws), the rule's p
    and verdict, and the draws left unfinished."""
    a, b = outcomes(read_rows(path_a)), outcomes(read_rows(path_b))
    fa, na = sum(f for _, f in a["draws"]), len(a["draws"])
    fb, nb = sum(f for _, f in b["draws"]), len(b["draws"])
    return dict(a=f"{fa}/{na}", b=f"{fb}/{nb}", **fault_or_rounding(fa, na, fb, nb),
                unfinished=dict(a=a["unfinished"], b=b["unfinished"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("draws")
    d.add_argument("--grid", type=int, default=5000)
    d.add_argument("--ulps", default=",".join(map(str, GODDARD_ULPS)))
    d.add_argument("--device", default="cuda")
    d.add_argument("--scan-source", help="another source of the scan kernel (the card only)")
    d.add_argument("--max-iter", type=int)
    d.add_argument("--deadline", type=float, default=float("inf"), help="seconds")
    d.add_argument("--json", help="also append the draws' lines here")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        print(json.dumps(compare(args.a, args.b)))
        return 0
    out = open(args.json, "a") if args.json else None

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    run_draws(args.grid, [int(k) for k in args.ulps.split(",")], args.device, args.scan_source, args.max_iter,
              args.deadline, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
