"""BASELINE config 4 on the card: orbit transfer (fuel-min, free tf) over a
batch of scenarios, each with its own initial state and tf deadline,
midpoint collocation. The port's counterpart of
benchmarks/orbit_scenarios.py.

    python -m ctdirect_tpu_torch.orbit_scenarios [--batch 2048] [--n 500] [--max-iter 30] [--sigma 1e-3]
        [--json PATH] [--cpu]

It runs on the card (the CPU only with --cpu) and does what the reference
does, in the same order:
  1. transcribes orbit_transfer at N steps with the midpoint scheme, f64
     (N=500: nz = 3005, nc = 2508; a KKT chain of P=512 blocks, bs=11,
     wb=13);
  2. solves the nominal transfer from the fixture's guess (solve_docp, tol
     1e-6, max_iter 3000, no least-squares multiplier start, the default
     structured KKT solve): on a card the compiled B=1 solve
     (solver/interface.py::DOCPSolver), whose first call captures; its
     wall, iterations, host syncs per iteration, capture s and segment
     graphs;
  3. makes B scenarios from it (`make_scenarios`): the nominal as every
     scenario's warm start, the initial state moved by sigma N(0, 1)
     through the first four boundary rows, and a tf deadline of 15 +
     U(-1, 1) per scenario through zu;
  4. solves them with BatchSolver (kkt_mode="cr": one CR kernel launch
     per batched KKT solve; tol 1e-6, --max-iter iterations, no
     least-squares start) three times: the eager solve (BatchSolver.eager),
     the first graphed call (its ten segments captured as CUDA graphs at
     their first use) and a replay. Each prints its wall, solves/s,
     converged share, median iterations, host syncs per iteration, batched
     KKT solves, CR kernel launches, and the graphed calls their capture s,
     segment graphs, pool MiB; every call its peak device memory
     (torch.cuda.max_memory_allocated).
Checks (a failed one exits non-zero):
  - the nominal successful, its objective within NOMINAL_RTOL of the JAX
    package's on the CPU under the same options (JAX_NOMINAL);
  - the first graphed call and the replay equal to the eager solve within
    GRAPH_TOL over every field and instance (bitwise expected), with the
    same KKT solves, host syncs and segment runs; on the card each call's
    CR kernel launches are its KKT solves (plus, in the first call, those
    of the segment warm-ups), each of 3 + 3 log2 P CUDA launches;
  - the batch with its rows moved at random, each only among the rows of
    its alignment class (b mod ALIGN_PERIOD; on the card a graphed call
    under torch.profiler, utils/profiling.py's profiled_solve, which sees
    KKT solves x (3 + 3 log2 P) CR CUDA launches, its device busy / idle
    share and the CR kernel's share of busy printed), gives every row the
    result it had in place, bit for bit: no row's
    arithmetic depends on the other rows, nor on its position but through
    the alignment of its data, which such a move keeps, while every row
    gets new neighbours in its warp, block and tile. With `diagnostics`
    the batch shifted by WITNESS_SHIFTS rows too: by a multiple of the
    period held bit for bit, by fewer rows printed (another alignment,
    other rounding). Three scenarios re-solved alone (B=1, compiled on a
    card) are printed beside their rows;
  - the converged share is at least ORBIT_MIN_CONVERGED.
Two of these differ from what a converging batch would allow, because
this workload's KKT steps are ill-determined under block elimination.
Every scenario starts from the nominal z with zero multipliers (no
least-squares start), and block elimination, which the CR and the
structured scan both are, is unstable on its first KKT system: at N=40
that system's condition number is 7.5e5 and a dense solve meets it to a
relative residual of 1e-18, but the CR's residual is 3.4e-3 in both
packages (the same solution bit for bit on the same blocks), and one ulp
more on every entry of its diagonal blocks moves the CR's step by 9.4e3
(tests/orbit_cpu_reference.py, PERF.md). So two solves whose assembly
rounds differently part by O(1) from the first iteration, and no scenario
converges in 30 iterations (the JAX package: none of rows 0-15 at N=500).
So a scenario solved alone is printed beside its row of the batch, not
held to it (on the CPU a B=1 solve and its row of a B=4 batch, which round
differently, part by O(1) in z from the first iteration), and the batch
with its rows moved within their alignment classes, which rounds each row
as before, holds the rows instead; and the nominal, whose hundreds of
iterations carry rounding into another nearby local optimum (the JAX
package's structured and CR nominals end 3.5e-5 apart at N=500), is held to
the JAX package's objective within NOMINAL_RTOL, which still tells the
revolution basins apart (0.17 against 0.47).
With `diagnostics` it then gives the device ms by stage of one eager
batched solve under the profiler (utils/profiling.py's stage_split:
prepare, assemble, the CR kernel, the block solve's casts and padding, the
rest of the KKT solve, and the rest of the IPM iteration). A batch that
does not fit on the card raises with what it asked for; nothing is split
into smaller batches. It prints the card's name and power limit
(nvidia-smi), one line per measurement and, last, one JSON object (also
written to --json).

`run(cfg)` and `report(result, cfg)` are the same run and checks for a
caller that picks its own sizes (chip_smoke.py's phase 15)."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# benchmarks/orbit_scenarios.py's command line defaults
# and the diagnostics: the stage split and the alignment witness (~125 s and
# ~120 s at B=2048)
DEFAULT_CFG = dict(B=2048, N=500, max_iter=30, sigma=1e-3, nominal_mode="structured", diagnostics=True)
# the nominal solve's options (benchmarks/orbit_scenarios.py:64-72; kkt_mode from cfg["nominal_mode"])
NOMINAL_OPTS = dict(tol=1e-6, max_iter=3000, lsq_lambda_init=False)
# the JAX package's nominal solve under the same options, f64 on the CPU, by
# (kkt_mode, N): (objective, iterations) of solve_docp(transcribe(orbit_transfer,
# N, "midpoint"), init=the fixture's, NOMINAL_OPTS), each Solve_Succeeded
# (tests/orbit_cpu_reference.py prints them; PERF.md)
JAX_NOMINAL = {("structured", 500): (0.17222008258684676, 850), ("cr", 500): (0.17221404268125462, 564)}
# the same revolution basin (module docstring): 30x the spread of the JAX
# package's own two nominals at N=500, 3x the card's CR nominal's distance
# (3.2e-4, PERF.md)
NOMINAL_RTOL = 1e-3
# min(0.95, the share that the JAX package converges on the CPU: BatchSolver at
# N=500 over rows 0-15 of the B=2048 draw, kkt=StructuredKKT(algorithm="cr"),
# warm from its own nominal, the batch options below: 0 of 16;
# tests/orbit_cpu_reference.py, PERF.md)
ORBIT_MIN_CONVERGED = 0.0
# a graphed solve against the eager solve (bitwise expected)
GRAPH_TOL = 1e-13
# rows of a batch round alike on the card where their data start at the same
# address modulo 32 bytes: PyTorch's CUDA reductions along a row read four
# f64 at a time from 32-byte-aligned addresses and add the unaligned head
# apart. A row of nz = 3005 f64 is 24,040 bytes, 8 modulo 32, so row b
# rounds by b mod 4: on the card shifts of the batch by 4 and 8 rows are
# bitwise, by 1, 2 and 3 rows they move results by up to 6.8e4-3.4e6 (PERF.md)
ALIGN_PERIOD = 4
# the alignment witness's shifts (rows): below the period and multiples of it
WITNESS_SHIFTS = (1, 2, 3, 4, 8)


def batch_options(cfg):
    from ctdirect_tpu_torch.solver.ipm import IPMOptions

    return IPMOptions(tol=1e-6, max_iter=cfg["max_iter"], lsq_lambda_init=False, kkt_mode="cr")


def make_scenarios(docp, B: int, sigma: float, seed: int = 0, nominal=None):
    """(z0, cl, cu, zl, zu) of B scenarios on the DOCP's device, made as
    benchmarks/orbit_scenarios.py:74-91 makes them, draws in its order: z0
    the warm start from `nominal` (a Solution; the DOCP's default guess
    without one), broadcast over B; the initial state moved by sigma N(0, 1)
    through the first four boundary rows (the x(t0) pins) of cl and cu; then
    zu's last entry (tf) a deadline of 15 + U(-1, 1) per scenario."""
    from ctdirect_tpu_torch.model.init import InitialGuess

    z_nom = docp.initial_guess(None if nominal is None else InitialGuess.from_solution(nominal))
    rng = np.random.default_rng(seed)
    rows = docp.boundary_row_indices()[:4]
    cl = np.tile(docp._c_lb, (B, 1))
    cu = np.tile(docp._c_ub, (B, 1))
    dx0 = sigma * rng.standard_normal((B, 4))
    cl[:, rows] += dx0
    cu[:, rows] += dx0
    zl = np.tile(docp._z_lb, (B, 1))
    zu = np.tile(docp._z_ub, (B, 1))
    zu[:, -1] = 15.0 + rng.uniform(-1.0, 1.0, B)
    z0 = docp.tensor(z_nom).expand(B, -1)
    return (z0, *(docp.tensor(x) for x in (cl, cu, zl, zu)))


def aligned_permutation(B: int, seed: int = 0) -> np.ndarray:
    """A random permutation of B rows that moves each row only among the
    rows of its alignment class (b mod ALIGN_PERIOD)."""
    rng = np.random.default_rng(seed)
    perm = np.arange(B)
    for r in range(ALIGN_PERIOD):
        perm[r::ALIGN_PERIOD] = rng.permutation(perm[r::ALIGN_PERIOD])
    return perm


def _host_s(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _nominal(docp, prob, cfg, kernel):
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.solver.interface import _get_solver, solve_docp

    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched

    opts = ct.IPMOptions(kkt_mode=cfg["nominal_mode"], **NOMINAL_OPTS)
    kernel.reset_counts()
    scan_solve_batched.reset_counts()
    sol, wall = _host_s(lambda: solve_docp(docp, init=prob.init, options=opts), docp.device)
    stats = _get_solver(docp, opts).stats
    out = dict(mode=cfg["nominal_mode"], wall_s=wall, status=sol.status, message=sol.message,
               launches=kernel.launches, grid_launches=kernel.grid_launches, scan_launches=scan_solve_batched.launches,
               successful=sol.successful, objective=sol.objective, iterations=sol.iterations,
               host_syncs=stats.host_syncs, batch_iterations=stats.iterations,
               block_solves=sol.infos.get("kkt_block_solves"),
               warmup_block_solves=sol.infos.get("kkt_warmup_block_solves"), captures=sol.infos.get("captures", 0),
               capture_s=sol.infos.get("capture_s", 0.0))
    docp.release_solvers()
    return sol, out


def _batch_calls(solver, inputs, kernel, B):
    """The eager solve, the first graphed call and a replay (on the CPU all
    three are the eager solve), each with its counts reset just before."""
    from ctdirect_tpu_torch.solver.graph import result_diff
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    dev = solver.device
    calls, ref = {}, None
    for tag, fn in (("eager", solver.eager), ("first graphed call", solver), ("graphed replay", solver)):
        solver.stats = BatchStats()
        graph = solver.graphs.get(B)
        capture0 = graph.capture_s if graph else 0.0
        warm0 = graph.warmup_added[kernel, "launches"] if graph else 0
        kernel.reset_counts()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            res, wall = _host_s(lambda: fn(*inputs), dev)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(f"orbit scenarios, {tag}: a batch of B={B} does not fit on the card "
                               f"({torch.cuda.get_device_name(dev)}): {e}") from e
        st, graph = solver.stats, solver.graphs.get(B)
        rec = dict(wall_s=wall, iterations=st.iterations, kkt_solves=st.kkt_solves, host_syncs=st.host_syncs,
                   segments=dict(st.segments), launches=kernel.launches, grid_launches=kernel.grid_launches,
                   warmup_launches=graph.warmup_added[kernel, "launches"] - warm0 if fn is solver and graph else 0,
                   converged=float(res.successful.double().mean()),
                   median_iterations=float(np.median(res.iterations.cpu().numpy())),
                   max_iterations=int(res.iterations.max()),
                   finite=bool(torch.isfinite(res.z).all()), shape=tuple(res.z.shape),
                   peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None)
        if graph is not None and fn is solver:
            rec.update(capture_s=graph.capture_s - capture0, captures=solver.captures,
                       pool_mib=graph.pool_bytes / 2**20)
        if ref is None:
            ref = (res, st)
        else:
            rec.update(vs_eager=result_diff(res, ref[0]), bitwise=all(torch.equal(a, b) for a, b in zip(res, ref[0])),
                       same_counts=st == ref[1])
        calls[tag] = rec
        last = res
    return calls, last


def run(cfg: dict, device="cuda") -> dict:
    """The measurements of `cfg` (DEFAULT_CFG's keys) on `device`: numbers
    and small lists only (report checks and prints them)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.graph import result_diff
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.solver.ipm import BatchStats
    from ctdirect_tpu_torch.utils import profiling

    dev = torch.device(device)
    B, N = cfg["B"], cfg["N"]
    out = dict(device=str(dev), card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", B=B, N=N)
    prob = get_problem("orbit_transfer")
    docp = ct.transcribe(prob.ocp, grid_size=N, scheme="midpoint", device=dev)
    kkt_chain = 1 << (N - 1).bit_length()
    out.update(nz=docp.nz, nc=int(docp._c_lb.shape[0]), P=kkt_chain)
    nominal, out["nominal"] = _nominal(docp, prob, cfg, kernel)

    inputs = make_scenarios(docp, B, cfg["sigma"], nominal=nominal)
    opts = batch_options(cfg)
    solver = BatchSolver(docp, opts, device=dev)
    out.update(bs=solver.kkt.d.bs, wb=solver.kkt.d.wb)
    out["calls"], res = _batch_calls(solver, inputs, kernel, B)
    per = len(kernel.plan(kkt_chain, 1, 0, 1, 8)) if dev.type == "cuda" else 0
    out["grid_per_solve"] = per

    def moved(rows):  # the batch with its rows in another order, against its own rows
        rows = torch.as_tensor(rows, device=dev)
        return result_diff(solver(*(x[rows] for x in inputs)), [x[rows] for x in res])

    perm = torch.as_tensor(aligned_permutation(B), device=dev)
    if dev.type == "cuda":
        # the graphed solve of the permuted batch is the profiled one (each
        # profile taken runs it; every run held to the rows in place)
        permuted, runs = [x[perm] for x in inputs], []
        solver.stats = BatchStats()
        try:
            out["profiled"] = profiling.profiled_solve(lambda: runs.append(solver(*permuted)),
                                                       lambda: solver.stats.kkt_solves, per)
        except AssertionError as e:
            out["profiled"] = dict(error=str(e))
        rows = [x[perm] for x in res]
        out["permuted_diff"] = max(result_diff(r, rows) for r in runs)
        del permuted, runs, rows
    else:
        out["permuted_diff"] = moved(perm)
    if cfg["diagnostics"]:
        out["shift_diff"] = {s: moved(np.roll(np.arange(B), s)) for s in WITNESS_SHIFTS}
    # three scenarios alone (B=1; printed beside their rows, not compared:
    # module docstring)
    z0, cl, cu, zl, zu = inputs
    run_one = _get_solver(docp, opts)
    out["one"] = []
    for b in sorted({0, B // 2, B - 1}):
        (r, _), wall = _host_s(lambda: run_one(z0[b], zl[b], zu[b], cl[b], cu[b]), dev)
        out["one"].append(dict(row=b, wall_s=wall, status=(int(r.status), int(res.status[b])),
                               iterations=(int(r.iterations), int(res.iterations[b])),
                               objective=(float(r.objective), float(res.objective[b])),
                               z_diff=float((r.z - res.z[b]).abs().max())))
    docp.release_solvers()

    if dev.type == "cuda" and cfg["diagnostics"]:
        with profiling.kkt_ranges(solver.kkt):
            _, prof, wall, _ = profiling.device_profile(lambda: solver.eager(*inputs))
        out["stages"] = profiling.stage_split(prof, 1, outside="rest of the iteration")
        out["stages_wall_s"] = wall
        del prof
    return out


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _call_line(tag, c, B):
    line = (f"  {tag}: {c['wall_s']:.3f} s wall -> {B / c['wall_s']:.1f} solves/s; converged "
            f"{100 * c['converged']:.2f}%, median iterations {c['median_iterations']:g} (max {c['max_iterations']}); "
            f"{c['iterations']} batch iterations, {c['kkt_solves']} batched KKT solves, {c['host_syncs']} host syncs "
            f"({c['host_syncs'] / max(c['iterations'], 1):.2f} per iteration); CR kernel launches {c['launches']} "
            f"({c['grid_launches']} CUDA launches)")
    if "capture_s" in c:
        line += (f", {c['warmup_launches']} of them in segment warm-ups; capture {c['capture_s']:.3f} s, "
                 f"{c['captures']} segment graphs, pool {c['pool_mib']:.1f} MiB")
    if c["peak_mib"] is not None:
        line += f"; peak device memory {c['peak_mib']:.1f} MiB"
    if "vs_eager" in c:
        line += (f"; vs eager: max abs diff {c['vs_eager']:.3e} over every field and instance "
                 f"({'bitwise equal' if c['bitwise'] else 'not bitwise'}; bound {GRAPH_TOL:g})")
    return line


def report(result: dict, cfg: dict, log=print) -> dict:
    """Check `run`'s result (module docstring) and print one line per
    measurement; returns the summary (JSON-ready). Raises AssertionError on
    a failed check."""
    B, N, card = result["B"], result["N"], result["device"].startswith("cuda")
    nom = result["nominal"]
    ref, ref_iters = JAX_NOMINAL.get((nom["mode"], N), (float("nan"), "not recorded"))
    rel = abs(nom["objective"] - ref) / abs(ref)
    per_it = nom["host_syncs"] / nom["batch_iterations"] if nom["batch_iterations"] else float("nan")
    log(f"orbit_transfer midpoint N={N} (nz={result['nz']}, nc={result['nc']}; KKT chain P={result['P']}, "
        f"bs={result['bs']}, wb={result['wb']}), f64 on {result['card']}")
    log(f"  nominal solve ({nom['mode']} KKT solve{', compiled' if card else ''}): {nom['message']}, objective "
        f"{nom['objective']!r} (the JAX package's on the CPU {ref!r}, rel diff {rel:.2e}, bound {NOMINAL_RTOL:g}), "
        f"{nom['iterations']} iterations (the JAX package's: {ref_iters}; not compared), {nom['wall_s']:.3f} s wall "
        f"(first call: capture {nom['capture_s']:.3f} s, {nom['captures']} segment graphs), {per_it:.2f} host syncs "
        f"per iteration, {nom['block_solves']} block solves (+ {nom['warmup_block_solves']} in segment warm-ups), "
        f"CR kernel launches {nom['launches']} ({nom['grid_launches']} CUDA launches), scan kernel launches "
        f"{nom['scan_launches']}")
    _check(nom["successful"], f"orbit nominal: {nom['message']}")
    if card:
        solves = nom["block_solves"] + nom["warmup_block_solves"]
        want = (solves, 0) if nom["mode"] == "cr" else (0, solves)
        _check((nom["launches"], nom["scan_launches"]) == want,
               f"orbit nominal ({nom['mode']}): CR / scan kernel launches {nom['launches']} / {nom['scan_launches']} "
               f"for {solves} block solves (warm-ups included)")
    _check(rel <= NOMINAL_RTOL, f"orbit nominal: objective {nom['objective']!r} vs the JAX package's {ref!r} "
                                f"(rel diff {rel:.3e}, bound {NOMINAL_RTOL:g})")

    calls = result["calls"]
    log(f"  scenario batch: B={B}, sigma {cfg['sigma']:g}, seed 0, BatchSolver kkt_mode='cr' tol 1e-6 "
        f"<= {cfg['max_iter']} iterations; eager, first graphed call, graphed replay")
    eager = calls["eager"]
    for tag, c in calls.items():
        log(_call_line(tag, c, B))
        _check(c["finite"] and c["shape"] == (B, result["nz"]), f"orbit batch, {tag}: z not finite or of shape "
                                                                 f"{c['shape']}")
        if "vs_eager" in c:
            _check(c["vs_eager"] <= GRAPH_TOL and c["same_counts"],
                   f"orbit batch, {tag}: differs from the eager solve by {c['vs_eager']:.3e} (bound {GRAPH_TOL:g}) "
                   f"or in its KKT solves, syncs or segment runs")
        if card:
            _check(c["launches"] == c["kkt_solves"] + c["warmup_launches"] and c["launches"] > 0,
                   f"orbit batch, {tag}: {c['launches']} CR kernel launches, {c['kkt_solves']} batched KKT solves + "
                   f"{c['warmup_launches']} in segment warm-ups")
            _check(c["grid_launches"] == c["launches"] * result["grid_per_solve"],
                   f"orbit batch, {tag}: {c['grid_launches']} CUDA launches, planned "
                   f"{c['launches']} x {result['grid_per_solve']}")
    if card:
        _check(calls["first graphed call"].get("captures", 0) > 0, "orbit batch: the graphed call captured nothing")
    log(f"  segment runs per solve: {eager['segments']}; the replay's speed-up over the eager solve "
        f"{eager['wall_s'] / calls['graphed replay']['wall_s']:.2f}x")

    p = result.get("profiled")
    if p is not None:
        _check("error" not in p, f"orbit batch, profiled graphed solve: {p.get('error')}")
        replay = calls["graphed replay"]["wall_s"]
        log(f"  device split, the permuted batch's graphed solve under torch.profiler: wall {p['wall']:.3f} s, "
            f"device busy {p['busy']:.3f} s ({100 * p['busy'] / p['wall']:.1f}%, idle "
            f"{100 * (1 - p['busy'] / p['wall']):.1f}%; idle "
            f"{100 * (1 - p['busy'] / replay):.1f}% of the unprofiled replay's {replay:.3f} s), CR kernel "
            f"{p['cr']:.3f} s ({100 * p['cr'] / p['busy']:.1f}% of busy, {p['cr_launches']} CUDA launches of it seen "
            f"= {p['cr_launches'] // result['grid_per_solve']} KKT solves x {result['grid_per_solve']}), "
            f"{p['launches']} kernel launches; CUPTI dropped {p['dropped']} activity records over {p['tries']} "
            f"profiles")

    log(f"  the batch with its rows moved at random within their alignment class (b mod {ALIGN_PERIOD}"
        f"{', graphed' if card else ''}): each row's result within {result['permuted_diff']:.1e} of its own (held "
        f"bit for bit)")
    _check(result["permuted_diff"] == 0.0, f"orbit batch: moving rows within their alignment class moved a row's "
                                           f"result by {result['permuted_diff']:.3e}")
    for s, d in result.get("shift_diff", {}).items():
        held = s % ALIGN_PERIOD == 0 and B % ALIGN_PERIOD == 0
        log(f"  the batch shifted by {s} rows: each row's result within {d:.3e} of its own "
            f"({'the same alignment: held bit for bit' if held else 'another alignment: not held'})")
        _check(d == 0.0 or not held, f"orbit batch: a shift by {s} rows moved a row's result by {d:.3e}")
    for o in result["one"]:
        log(f"  scenario {o['row']} alone (B=1{', compiled' if card else ''}, {o['wall_s']:.3f} s): status "
            f"{o['status'][0]}, {o['iterations'][0]} iterations, objective {o['objective'][0]:.12g}; in the batch: "
            f"status {o['status'][1]}, {o['iterations'][1]} iterations, objective {o['objective'][1]:.12g}; z diff "
            f"{o['z_diff']:.3e} (not compared: module docstring)")

    share = calls["graphed replay"]["converged"]
    _check(share >= ORBIT_MIN_CONVERGED, f"orbit batch: converged share {share:.4f} < {ORBIT_MIN_CONVERGED}")

    if "stages" in result:
        split = result["stages"]
        total = sum(split.values())
        log(f"  stage split, eager batched solve under torch.profiler ({result['stages_wall_s']:.3f} s wall), device "
            f"ms: " + ", ".join(f"{k} {v:.3f} ({100 * v / total:.1f}%)"
                                for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
            + f"; sum {total:.3f}")
    return dict(result, nominal_rel_diff=rel, solves_per_s={k: B / c["wall_s"] for k, c in calls.items()})


def main(argv=None):
    parser = argparse.ArgumentParser(description="BASELINE config 4: the orbit-transfer scenario batch")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the card)")
    parser.add_argument("--batch", type=int, default=DEFAULT_CFG["B"])
    parser.add_argument("--n", type=int, default=DEFAULT_CFG["N"])
    parser.add_argument("--max-iter", type=int, default=DEFAULT_CFG["max_iter"])
    parser.add_argument("--sigma", type=float, default=DEFAULT_CFG["sigma"])
    parser.add_argument("--json", help="also write the JSON summary here")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("orbit_scenarios: no CUDA device (--cpu runs on the CPU)", file=sys.stderr)
        sys.exit(1)
    from ctdirect_tpu_torch.shard_timing import card_line

    cards = "cpu" if args.cpu else card_line()
    print(cards, flush=True)
    cfg = dict(DEFAULT_CFG, B=args.batch, N=args.n, max_iter=args.max_iter, sigma=args.sigma)
    t0 = time.perf_counter()
    result = run(cfg, device="cpu" if args.cpu else "cuda")
    result.update(cards=cards.splitlines(), wall_s=time.perf_counter() - t0)
    if args.json:  # the measurements, kept where a check below fails
        with open(args.json, "w") as f:
            f.write(json.dumps(result, default=str) + "\n")
    summary = report(result, cfg, log=lambda m: print(m, flush=True))
    print(json.dumps(summary, default=str))


if __name__ == "__main__":
    main()
