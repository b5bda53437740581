"""BASELINE config 5 across cards: the batch-sharded MPC tick and the
batch-sharded BatchSolver, one card per rank, timed at 1, 2, 4, ... cards.
The port's counterpart of benchmarks/multihost.py in its single-host mode
(SCALING.md's weak-scaling protocol: a fixed batch per card, linearity =
solves/s(D) / (D x solves/s(1))).

    python -m ctdirect_tpu_torch.multihost --nproc 4 [--problem double_integrator_minenergy|cartpole]
        [--batch-per-chip N] [--ticks T] [--json PATH] [--cpu]

For every D among the powers of two up to --nproc it spawns a world of D
ranks (parallel/spmd.py: NCCL, one card each; with --cpu a gloo world on
the CPU) and runs on each rank, for each problem of PROBLEMS (both unless
--problem names one):
  1. the problem transcribed with the trapeze scheme in f64, the mesh
     (D,) "batch" and MPCController(resolve_iters=3, kkt_algorithm="cr",
     mesh=, batch_axis="batch"): on a card a replayed CUDA graph per input
     signature with one CR kernel launch per Newton step inside;
  2. the warm state: the compiled cold start under the problem's options
     (as its reference script runs it), tiled over the rank's rows: the
     per-card batch B_local of a global batch B = B_local x D;
  3. each tick's global x0: scale x default_rng((seed, tick)).standard_normal((B, nx))
     x weights; rank r ticks rows [r B_local, (r+1) B_local), so a row's
     draws do not depend on D (benchmarks/multihost.py draws every tick
     from one default_rng(host_id) stream instead);
  4. one call that captures (not timed), WARMUP ticks, a barrier, then T
     timed ticks: the host clock over the pipelined loop to one
     synchronize, and CUDA events per tick (p50 / p90); the global tick
     time is the slowest rank's (an all_reduce MAX after the window);
  5. the same T ticks again, each replay followed by one all_reduce MAX of
     the rank's max KKT over the batch axis, outside the graph, read to the
     host once at the end: the cost of a collective on the batch axis
     (benchmarks/multihost.py:139-157);
  6. the eager tick (MPCController.eager) from the same warm state over the
     first EAGER_TICKS x0s: the reference the replay is held to;
  7. on a card, one more replay under torch.profiler
     (utils/profiling.py::kernel_events), which must see the CR kernel's
     planned CUDA launches and no NCCL kernel;
  8. cart-pole only: BatchSolver(kkt_mode="cr", tol 1e-6, 30 iterations at
     most, mesh=) over 1,024 x D scenarios, each with its own x0
     (scale x default_rng(seed).standard_normal((B, 4)) x weights) from the
     cold-start solution: a first graphed call and a replay, each timed to
     a synchronize (the slowest rank's), the all_gather at the end outside
     the graphs; then rank 0 alone solves its rows eagerly without a mesh.
Checks (`report`; a failed one makes the script exit non-zero, after it has
printed every line and the JSON):
  - the replayed tick equals the eager tick within GRAPH_TOL (bitwise
    expected): u0 and KKT at every tick, and the states after the last;
  - rank 0's rows are bitwise the same at every D (the same program on the
    same data): u0 and KKT at every tick and the final states, and the
    BatchSolver's result;
  - max KKT below the problem's kkt_max where it has one (1e-10, the
    double integrator; cart-pole's 3 Newton steps do not converge: its
    KKT is reported);
    u0 finite and within the force box (cart-pole);
  - the tick sends no message: the batch axis's ShardAxis.messages stays
    put over the timed loop; the isolation loop adds exactly one per tick;
  - the CR kernel's launches grow by exactly ticks x 3 on every rank (on
    the CPU the operator's block solves, the kernel's plain version
    counting none), each of the planned CUDA launches; the profiled
    replay sees those CUDA launches and no NCCL kernel;
  - the BatchSolver's replay equals its first graphed call and, on rank
    0's rows, the eager solve without a mesh, within GRAPH_TOL over every
    field (bitwise expected), with its kernel launches its KKT solves (in
    the first call plus the segment warm-ups'); the converged share is at
    least CP_MIN_CONVERGED.
It prints the cards' names and power limits (nvidia-smi), one line per
(problem, D) and, last, one JSON object (also written to --json).

`run(nproc, cfg)` and `report(results, cfg)` are the same run and checks
for a caller that picks its own sizes (chip_smoke.py's phase 17: one rank;
tests/test_torch_multihost.py: gloo worlds of 1 and 2 ranks)."""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ctdirect_tpu_torch.shard_timing import card_line, digest, max_diff

# the reference scripts' settings: benchmarks/multihost.py:92-102 (the
# double integrator) and benchmarks/mpc_cartpole.py:60-80 (cart-pole, with
# the scenario batch of chip_smoke.py's phase 9)
PROBLEMS = {
    "double_integrator_minenergy": dict(
        N=100, rows=(0, 1), x0_scale=0.03, x0_weights=(1.0, 1.0), cold=dict(tol=1e-8, max_iter=60), init=False,
        batch_per_chip=512, kkt_max=1e-10),
    # 25,000 a card: BASELINE config 5's 100k controllers on four cards (PERF.md)
    "cartpole": dict(
        N=60, rows=(0, 1, 2, 3), x0_scale=0.02, x0_weights=(1.0, 1.0, 0.5, 0.5), cold=dict(tol=1e-8, max_iter=200),
        init=True, batch_per_chip=25_000, kkt_max=None, umax=12.0,
        solver=dict(batch_per_chip=1024, tol=1e-6, max_iter=30, lsq_lambda_init=False)),
}
ITERS = 3  # Newton steps per tick
WARMUP, TIMED = 2, 30
EAGER_TICKS = 7  # 2 warm-up + 5 timed
SEED = 0
# a compiled form against its eager form (PERF.md section 2)
GRAPH_TOL = 1e-13
# min(0.95, the share the JAX package converges on the CPU for the first 16
# of the scenario draws under the same options: 7 of 16, PERF.md)
CP_MIN_CONVERGED = 0.4375
TIMEOUT = 1800.0


def sizes_up_to(nproc: int) -> list:
    """The powers of two up to nproc: the D of each world."""
    return [1 << k for k in range(nproc.bit_length()) if (1 << k) <= nproc]


def split_rows(B: int, D: int, rank: int) -> slice:
    """Rank `rank`'s rows of a global batch of B over D ranks; ValueError
    where B does not split evenly."""
    if B % D:
        raise ValueError(f"a batch of {B} does not split over {D} ranks")
    per = B // D
    return slice(rank * per, (rank + 1) * per)


def x0_draws(pc: dict, seed: int, ticks: int, B: int) -> list:
    """The global x0 of each tick, (B, nx) each: row b of tick k is the same
    for every B > b."""
    w = np.array(pc["x0_weights"])
    return [pc["x0_scale"] * np.random.default_rng((seed, k)).standard_normal((B, len(w))) * w for k in range(ticks)]


def scenario_x0(pc: dict, seed: int, B: int) -> np.ndarray:
    """The BatchSolver's per-instance x0, (B, nx) (at seed 0 and B=1024
    chip_smoke.py's phase 9 batch)."""
    w = np.array(pc["x0_weights"])
    return pc["x0_scale"] * np.random.default_rng(seed).standard_normal((B, len(w))) * w


def default_cfg(problem=None, batch_per_chip=None, ticks=TIMED, device="cuda") -> dict:
    """The command line's run: every problem of PROBLEMS, or `problem`, at
    its per-card batch (or `batch_per_chip`), `ticks` timed ticks."""
    names = list(PROBLEMS) if problem is None else [problem]
    problems = {}
    for name in names:
        pc = dict(PROBLEMS[name], iters=ITERS, warmup=WARMUP, timed=ticks, eager=EAGER_TICKS)
        if batch_per_chip is not None:
            pc["batch_per_chip"] = batch_per_chip
        problems[name] = pc
    backend = "nccl" if device == "cuda" else "gloo"
    return dict(problems=problems, seed=SEED, device=device, backend=backend)


def check_cfg(cfg: dict) -> None:
    """ValueError for sizes no world can run: a per-card batch that is not
    a positive integer, fewer than one timed tick."""
    for name, pc in cfg["problems"].items():
        sizes = [pc["batch_per_chip"]] + ([pc["solver"]["batch_per_chip"]] if pc.get("solver") else [])
        for b in sizes:
            if not (isinstance(b, int) and b > 0):
                raise ValueError(f"{name}: a per-card batch must be a positive integer, not {b!r}")
        if pc["timed"] < 1 or pc["warmup"] < 0:
            raise ValueError(f"{name}: {pc['warmup']} warm-up and {pc['timed']} timed ticks")


# ---- on each rank ----

def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(world):
    _sync(world.device)
    if world.backend == "nccl":
        dist.barrier(device_ids=[world.device.index])
    else:
        dist.barrier()
    _sync(world.device)


def _mark(dev):
    """A point in the stream's time: a recorded CUDA event on a card, the
    host clock on the CPU (where work is synchronous)."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else 1e3 * (b - a)


def _slowest(world, group, values) -> list:
    """Each of `values` maxed over the ranks of `group` (one all_reduce)."""
    t = torch.tensor(values, dtype=torch.float64, device=world.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def _pass(world, tick, states, xs, warmup, keep=None, after=None):
    """xs through `tick` from `states`: `warmup` ticks, a barrier, then the
    rest timed (the host clock over the loop to one synchronize; a mark
    before and after each tick). `after(kkt)` runs after each timed tick
    and returns a tensor; the last one is read to the host inside the
    window. Returns u0 and KKT of every tick, the states after `keep`
    ticks and after the last, the timed ticks' ms and the window's s."""
    dev = world.device
    u0s, kkts, kept, marks, issued = [], [], None, [], None

    def step(k, states):
        states, u0, kkt, _ = tick(states, xs[k])
        u0s.append(u0)
        kkts.append(kkt)
        return states

    for k in range(warmup):
        states = step(k, states)
        if k + 1 == keep:
            kept = states
    _barrier(world)
    t0 = time.perf_counter()
    for k in range(warmup, len(xs)):
        m0 = _mark(dev)
        states = step(k, states)
        if after is not None:
            issued = after(kkts[-1])
        marks.append((m0, _mark(dev)))
        if k + 1 == keep:
            kept = states
    read = None if issued is None else float(issued)
    _sync(dev)
    window = time.perf_counter() - t0
    return dict(states=states, kept=kept, u0s=u0s, kkts=kkts, ms=[_ms(a, b) for a, b in marks], window_s=window,
                read=read)


def _counts(ctrl, kernel):
    return dict(messages=ctrl.axis.messages, block_solves=ctrl.kkt.block_solves, launches=kernel.launches,
                grid_launches=kernel.grid_launches)


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _profiled(kernel, fn, per):
    """One call of fn (a replay) under torch.profiler: the CR kernel's
    launches the wrapper counts in it, the CUDA launches of their plan
    that the profiler must see, and the NCCL kernels it saw; a failed
    check is recorded, not raised."""
    from ctdirect_tpu_torch.utils.profiling import kernel_events

    counted = {}

    def call():
        l0 = kernel.launches
        fn()
        counted["launches"] = kernel.launches - l0
        return counted["launches"] * per

    try:
        rec = kernel_events(call)
    except AssertionError as e:
        return dict(counted, error=str(e))
    return dict(counted, seen=rec["seen"], want=rec["want"], nccl=rec["totals"]["nccl_events"],
                dropped=rec["dropped"], profiles=rec["tries"])


def _memory(dev) -> dict:
    if dev.type != "cuda":
        return dict(peak_mib=None, peak_reserved_mib=None)
    return dict(peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                peak_reserved_mib=torch.cuda.max_memory_reserved(dev) / 2**20)


def _tick_leg(world, name, pc, cfg, kernel, per):
    """The batch-sharded tick of one problem on this rank (steps 1-7 of the
    module docstring), and cart-pole's BatchSolver (step 8)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import MPCController, broadcast_state
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    dev, D = world.device, world.size
    prob = get_problem(name)
    docp = ct.transcribe(prob.ocp, grid_size=pc["N"], scheme="trapeze", device=dev)
    mesh = world.mesh((D,), ("batch",))
    ctrl = MPCController(docp, x0_boundary_rows=list(pc["rows"]), resolve_iters=pc["iters"], kkt_algorithm="cr",
                         mesh=mesh, batch_axis="batch", device=dev, dtype=torch.float64)
    t0 = time.perf_counter()
    if pc.get("warm") is not None:
        warm = warm_state_from_numpy(pc["warm"], dev)
    else:
        warm = ctrl.cold_start(options=ct.IPMOptions(**pc["cold"]), init=prob.init if pc["init"] else None)
        docp.release_solvers()
    _sync(dev)
    cold_s = time.perf_counter() - t0

    B = pc["batch_per_chip"] * D
    mine = split_rows(B, D, ctrl.axis.rank)
    ticks = pc["warmup"] + pc["timed"]
    xs = [torch.tensor(x[mine], dtype=torch.float64, device=dev) for x in x0_draws(pc, cfg["seed"], ticks, B)]
    states0 = broadcast_state(warm, mine.stop - mine.start)
    n_eager = min(pc["eager"], ticks)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    ctrl(states0, xs[0])  # the first call of the signature captures
    _sync(dev)
    first_s = time.perf_counter() - t0
    c0 = _counts(ctrl, kernel)
    replay = _pass(world, ctrl, states0, xs, pc["warmup"], keep=n_eager)
    counts = _delta(_counts(ctrl, kernel), c0)
    c1 = _counts(ctrl, kernel)
    dp = _pass(world, ctrl, replay["states"], xs[pc["warmup"]:], 0, after=lambda kkt: ctrl.axis.pmax(kkt.max()))
    dp_counts = _delta(_counts(ctrl, kernel), c1)
    mem = _memory(dev)  # the replayed path's, before the eager reference
    slow = _slowest(world, ctrl.axis.group, [replay["window_s"], dp["window_s"]])
    eager = _pass(world, ctrl.eager, states0, xs[:n_eager], min(2, n_eager - 1))

    got = (*replay["u0s"][:n_eager], *replay["kkts"][:n_eager], *replay["kept"])
    ref = (*eager["u0s"], *eager["kkts"], *eager["states"])
    graph = next(iter(ctrl.graphs.values()), None)
    final = replay["states"]
    u0_all = torch.stack(replay["u0s"])
    out = dict(
        B=B, rows=(mine.start, mine.stop), ticks=ticks, timed=pc["timed"], graphed=ctrl.graphed,
        captures=ctrl.captures, cold_s=cold_s, first_s=first_s,
        capture_s=0.0 if graph is None else graph.capture_s,
        pool_mib=0.0 if graph is None else graph.pool_bytes / 2**20,
        p50=float(np.percentile(replay["ms"], 50)), p90=float(np.percentile(replay["ms"], 90)),
        host_ms=1e3 * replay["window_s"] / pc["timed"], dp_host_ms=1e3 * dp["window_s"] / pc["timed"],
        slowest_host_ms=1e3 * slow[0] / pc["timed"], slowest_dp_host_ms=1e3 * slow[1] / pc["timed"],
        dp_kkt_max=dp["read"], replay=counts, dp=dp_counts,
        eager=dict(p50=float(np.percentile(eager["ms"], 50)), ticks=n_eager),
        replay_eager=max_diff(got, ref), bitwise=all(map(torch.equal, got, ref)),
        kkt_max=max(float(k.max()) for k in replay["kkts"]),
        u0_finite=bool(torch.isfinite(u0_all).all()), u0_absmax=float(u0_all.abs().max()),
        digest=digest(*replay["u0s"], *replay["kkts"], *final), **mem,
        peak_with_eager_mib=_memory(dev)["peak_mib"])
    if pc.get("umax") is not None:
        u = final.z[:, docp.control_col_indices()]
        out["saturated"] = float((torch.abs(u.abs() - pc["umax"]) < 1e-6).double().mean())
    if dev.type == "cuda":
        out["profiled"] = _profiled(kernel, lambda: ctrl(final, xs[-1]), per)
    if cfg.get("arrays"):
        out.update(u0s=[u.cpu().numpy() for u in replay["u0s"]], kkts=[k.cpu().numpy() for k in replay["kkts"]],
                   states=[a.cpu().numpy() for a in final])
        if world.rank == 0:
            out["warm"] = {f: getattr(warm, f).cpu().numpy() for f in warm._fields}
    # the tick's graph pool and states go before the BatchSolver captures its own
    del ctrl, graph, replay, dp, eager, got, ref, final, states0, xs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if pc.get("solver"):
        out["solver"] = _solver_leg(world, pc, cfg, kernel, per, docp, warm, mesh)
    return out


def _solver_leg(world, pc, cfg, kernel, per, docp, warm, mesh):
    """Cart-pole's scenario batch through BatchSolver(mesh=): a first graphed
    call and a replay, then rank 0's rows solved eagerly on rank 0 alone."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.solver.graph import result_diff
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    dev, D, sc = world.device, world.size, pc["solver"]
    opts = ct.IPMOptions(tol=sc["tol"], max_iter=sc["max_iter"], lsq_lambda_init=sc["lsq_lambda_init"],
                         kkt_mode="cr")
    solver = BatchSolver(docp, opts, mesh=mesh, batch_axis="batch", device=dev)
    B = sc["batch_per_chip"] * D
    mine = split_rows(B, D, solver.axis.rank)
    rows = docp.boundary_row_indices()[list(pc["rows"])]
    x0 = scenario_x0(pc, cfg["seed"], B)
    cl, cu = np.tile(docp._c_lb, (B, 1)), np.tile(docp._c_ub, (B, 1))
    cl[:, rows] += x0
    cu[:, rows] += x0
    z0 = warm.z.expand(B, -1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    calls, results = {}, {}
    for tag in ("first", "replay"):
        solver.stats = BatchStats()
        graph = solver.graphs.get(B // D)
        warm0 = graph.warmup_added[kernel, "launches"] if graph else 0
        l0, g0 = kernel.launches, kernel.grid_launches
        _barrier(world)
        t0 = time.perf_counter()
        res = solver(z0, cl, cu)
        _sync(dev)
        wall = time.perf_counter() - t0
        st, graph = solver.stats, solver.graphs.get(B // D)
        calls[tag] = dict(wall_s=wall, iterations=st.iterations, kkt_solves=st.kkt_solves, host_syncs=st.host_syncs,
                          launches=kernel.launches - l0, grid_launches=kernel.grid_launches - g0,
                          warmup_launches=(graph.warmup_added[kernel, "launches"] - warm0) if graph else 0)
        results[tag] = res
    res = results["replay"]
    graph = solver.graphs.get(B // D)
    r0 = split_rows(B, D, 0)
    out = dict(B=B, rows=(mine.start, mine.stop), graphed=solver.graphed, captures=solver.captures,
               capture_s=0.0 if graph is None else graph.capture_s,
               pool_mib=0.0 if graph is None else graph.pool_bytes / 2**20, calls=calls,
               replay_first=result_diff(res, results["first"]),
               converged=float(res.successful.double().mean()), finite=bool(torch.isfinite(res.z).all()),
               digest=digest(*(x[r0] for x in res)), **_memory(dev))
    if world.rank == 0:
        ref = BatchSolver(docp, opts, device=dev).eager(z0[r0], cl[r0], cu[r0])
        rows0 = [x[r0] for x in res]
        out["eager_diff"] = result_diff(rows0, ref)
        out["eager_bitwise"] = all(torch.equal(a, b) for a, b in zip(rows0, ref))
    return out


def _rank(world, cfg):
    """One rank's measurements (numbers, strings and small numpy arrays)."""
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.sweep import chain_blocks

    dev = world.device
    out = dict(rank=world.rank, size=world.size, device=dev.type,
               card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    if dev.type == "cuda":
        kernel.library()
    for name, pc in cfg["problems"].items():
        P = chain_blocks(pc["N"])
        per = len(kernel.plan(P, 1, 0, 1, 8)) if dev.type == "cuda" else 3 + 3 * int(math.log2(P))
        out[name] = dict(_tick_leg(world, name, pc, cfg, kernel, per), per=per, P=P)
    return out


def run(nproc: int, cfg: dict, timeout: float = TIMEOUT) -> dict:
    """The measurements of `cfg` in a world of D ranks for each D of
    sizes_up_to(nproc) (cfg's backend: NCCL, one card each, or gloo on the
    CPU); returns {D: the ranks' results in rank order}. Raises ValueError
    before any world is spawned for a cfg no world can run or an NCCL
    world with more ranks than cards."""
    from ctdirect_tpu_torch.parallel.spmd import check_backend, launch

    check_cfg(cfg)
    device = torch.device(cfg["device"])
    check_backend(cfg["backend"], device.type, nproc)
    # the ranks' kineto prints CUPTI's dropped records (_profiled) at this level
    os.environ.setdefault("KINETO_LOG_LEVEL", "2")
    return {D: launch(_rank, D, device=cfg["device"], backend=cfg["backend"], args=(cfg,), timeout=timeout)
            for D in sizes_up_to(nproc)}


# ---- the checks and the lines ----

def _tick_checks(name, pc, D, ranks, fail):
    for r in ranks:
        t = r[name]
        tag = f"{name} D={D} rank {r['rank']}"
        ticks, want = t["ticks"], t["ticks"] * pc["iters"]
        if r["device"] == "cuda":
            if not (t["graphed"] and t["captures"] == 1):
                fail(f"{tag}: graphed {t['graphed']}, {t['captures']} captures")
            c = t["replay"]
            if not (c["launches"] == want and c["grid_launches"] == want * t["per"]):
                fail(f"{tag}: {c['launches']} CR launches ({c['grid_launches']} CUDA launches) in {ticks} ticks, "
                     f"planned {want} ({want * t['per']})")
            p = t["profiled"]
            if "error" in p or p["launches"] != pc["iters"] or p["nccl"]:
                fail(f"{tag}: the profiled replay: {p}")
        if t["replay"]["block_solves"] != want:
            fail(f"{tag}: {t['replay']['block_solves']} block solves in {ticks} ticks, planned {want}")
        if not t["replay_eager"] <= GRAPH_TOL:
            fail(f"{tag}: replay vs eager {t['replay_eager']:.3e}")
        if t["replay"]["messages"] != 0 or t["dp"]["messages"] != t["timed"]:
            fail(f"{tag}: {t['replay']['messages']} messages in the timed loop, {t['dp']['messages']} in the "
                 f"isolation loop of {t['timed']} ticks")
        if pc.get("kkt_max") is not None and not t["kkt_max"] < pc["kkt_max"]:
            fail(f"{tag}: max KKT {t['kkt_max']:.3e}, limit {pc['kkt_max']:g}")
        if not t["u0_finite"] or (pc.get("umax") is not None and not t["u0_absmax"] <= pc["umax"] * (1 + 1e-6)):
            fail(f"{tag}: u0 not finite or beyond the force box ({t['u0_absmax']:.6g})")
        slowest = max(q[name]["host_ms"] for q in ranks), max(q[name]["dp_host_ms"] for q in ranks)
        if (t["slowest_host_ms"], t["slowest_dp_host_ms"]) != slowest:
            fail(f"{tag}: the all-reduced slowest times {t['slowest_host_ms']}, {t['slowest_dp_host_ms']} are not "
                 f"the ranks' max {slowest}")


def _solver_checks(name, D, ranks, fail):
    for r in ranks:
        s = r[name]["solver"]
        tag = f"{name} BatchSolver D={D} rank {r['rank']}"
        if r["device"] == "cuda":
            first, c = s["calls"]["first"], s["calls"]["replay"]
            if not (s["graphed"] and s["captures"] > 0 and c["launches"] == c["kkt_solves"]
                    and first["launches"] == first["kkt_solves"] + first["warmup_launches"]
                    and c["grid_launches"] == c["launches"] * r[name]["per"]):
                fail(f"{tag}: graphed {s['graphed']}, {s['captures']} segment graphs, first call {first}, replay {c}")
        if not (s["replay_first"] <= GRAPH_TOL and s["finite"]):
            fail(f"{tag}: replay vs first call {s['replay_first']:.3e}, finite {s['finite']}")
        if "eager_diff" in s and not s["eager_diff"] <= GRAPH_TOL:
            fail(f"{tag}: rank 0's rows vs the eager solve {s['eager_diff']:.3e}")
        if not s["converged"] >= CP_MIN_CONVERGED:
            fail(f"{tag}: converged share {s['converged']:.4f} < {CP_MIN_CONVERGED}")


def report(results: dict, cfg: dict, log=print) -> dict:
    """Check the worlds' results (`run`; the module docstring's checks) and
    print one line per (problem, D) and one per BatchSolver world; returns
    the summary (JSON-ready), whose `failed` lists the failed checks."""
    failed = []
    fail = failed.append
    summary = dict(cards=sorted({r["card"] for ranks in results.values() for r in ranks}), problems={})
    for name, pc in cfg["problems"].items():
        rows, srows, base = [], [], {}
        for D, ranks in sorted(results.items()):
            _tick_checks(name, pc, D, ranks, fail)
            ts = [r[name] for r in ranks]
            t0 = ts[0]
            if D == 1:
                base = dict(tick=t0["digest"], sps=t0["B"] / (1e-3 * t0["slowest_host_ms"]))
            elif base and t0["digest"] != base["tick"]:
                fail(f"{name} D={D}: rank 0's rows differ from the D=1 run's ({t0['digest']} vs {base['tick']})")
            tick_ms = max(t["host_ms"] for t in ts)
            dp_ms = max(t["dp_host_ms"] for t in ts)
            sps = t0["B"] / (1e-3 * tick_ms)
            row = dict(D=D, B=t0["B"], p50=max(t["p50"] for t in ts), p90=max(t["p90"] for t in ts),
                       ms_per_tick=tick_ms, solves_per_s=sps, solves_per_s_per_chip=sps / D,
                       linearity=sps / (D * base["sps"]) if base else None,
                       ms_per_tick_with_dp_allreduce=dp_ms, dp_allreduce_cost_ms=dp_ms - tick_ms,
                       p50_per_rank=[t["p50"] for t in ts], capture_s=[t["capture_s"] for t in ts],
                       pool_mib=[t["pool_mib"] for t in ts], peak_mib=[t["peak_mib"] for t in ts],
                       cold_s=[t["cold_s"] for t in ts], eager_p50=max(t["eager"]["p50"] for t in ts),
                       cr_launches_per_tick=t0["replay"]["launches"] / t0["ticks"],
                       kkt_max=max(t["kkt_max"] for t in ts), replay_eager=max(t["replay_eager"] for t in ts),
                       bitwise=all(t["bitwise"] for t in ts))
            if "saturated" in t0:
                row["saturated"] = float(np.mean([t["saturated"] for t in ts]))
            if "profiled" in t0:
                row["profiled"] = [t["profiled"] for t in ts]
            rows.append(row)
            lin = "-" if row["linearity"] is None else f"{row['linearity']:.4f}"
            peak = ", ".join("-" if m is None else f"{m:.0f}" for m in row["peak_mib"])
            log(f"{name} N={pc['N']} tick, D={D}, B={row['B']} ({row['B'] // D} a card): p50 / p90 {row['p50']:.3f} / "
                f"{row['p90']:.3f} ms (slowest rank; per rank p50 "
                f"{', '.join('%.3f' % p for p in row['p50_per_rank'])}), host clock {tick_ms:.3f} ms a tick over "
                f"{t0['timed']} pipelined ticks -> {sps:.1f} solves/s, {sps / D:.1f} per card, linearity {lin}; "
                f"with the dp all_reduce {dp_ms:.3f} ms (+{dp_ms - tick_ms:.3f}); eager p50 {row['eager_p50']:.3f} ms; "
                f"capture {', '.join('%.2f' % c for c in row['capture_s'])} s, pool "
                f"{', '.join('%.0f' % m for m in row['pool_mib'])} MiB, peak {peak} MiB per rank; "
                f"{row['cr_launches_per_tick']:g} CR launches a tick; max KKT {row['kkt_max']:.3e}"
                + (f", saturated force {100 * row['saturated']:.2f}%" if "saturated" in row else "")
                + f"; replay vs eager {row['replay_eager']:.1e} ({'bitwise' if row['bitwise'] else 'not bitwise'})"
                + (f"; profiled replay {t0['profiled']}" if "profiled" in t0 else ""))
            if pc.get("solver"):
                _solver_checks(name, D, ranks, fail)
                ss = [t["solver"] for t in ts]
                s0 = ss[0]
                c = s0["calls"]["replay"]
                wall = max(s["calls"]["replay"]["wall_s"] for s in ss)
                ssps = s0["B"] / wall
                if D == 1:
                    base.update(solver=s0["digest"], solver_sps=ssps)
                elif "solver" in base and s0["digest"] != base["solver"]:
                    fail(f"{name} BatchSolver D={D}: rank 0's rows differ from the D=1 run's")
                srow = dict(D=D, B=s0["B"], first_s=max(s["calls"]["first"]["wall_s"] for s in ss), replay_s=wall,
                            solves_per_s=ssps, solves_per_s_per_chip=ssps / D,
                            linearity=ssps / (D * base["solver_sps"]) if "solver_sps" in base else None,
                            syncs_per_iteration=c["host_syncs"] / max(c["iterations"], 1), iterations=c["iterations"],
                            converged=s0["converged"], capture_s=[s["capture_s"] for s in ss],
                            pool_mib=[s["pool_mib"] for s in ss], peak_mib=[s["peak_mib"] for s in ss],
                            eager_diff=s0.get("eager_diff"), launches=c["launches"])
                srows.append(srow)
                lin = "-" if srow["linearity"] is None else f"{srow['linearity']:.4f}"
                log(f"{name} BatchSolver, D={D}, B={srow['B']}: first graphed call {srow['first_s']:.3f} s, replay "
                    f"{wall:.3f} s (slowest rank) -> {ssps:.1f} solves/s, {ssps / D:.1f} per card, linearity {lin}; "
                    f"{c['iterations']} iterations, {srow['syncs_per_iteration']:.2f} host syncs an iteration, "
                    f"{c['launches']} CR launches; converged {100 * srow['converged']:.2f}%; capture "
                    f"{', '.join('%.2f' % x for x in srow['capture_s'])} s, pool "
                    f"{', '.join('%.0f' % m for m in srow['pool_mib'])} MiB per rank; rank 0's rows vs eager "
                    f"{srow['eager_diff']:.1e}")
        summary["problems"][name] = dict(N=pc["N"], batch_per_chip=pc["batch_per_chip"], ticks=rows)
        if srows:
            summary["problems"][name]["solver"] = srows
    summary["failed"] = failed
    for f in failed:
        log(f"FAILED: {f}")
    return summary


def main(argv=None):
    parser = argparse.ArgumentParser(description="BASELINE config 5: the batch-sharded tick and BatchSolver, timed "
                                                 "on 1, 2, 4, ... cards")
    parser.add_argument("--nproc", type=int, default=4, help="the most ranks, one card each")
    parser.add_argument("--problem", choices=sorted(PROBLEMS), help="one problem (default: both)")
    parser.add_argument("--batch-per-chip", type=int, help="the tick's batch a card (default: PROBLEMS')")
    parser.add_argument("--ticks", type=int, default=TIMED, help="timed ticks")
    parser.add_argument("--json", help="also write the JSON summary here")
    parser.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("multihost: no CUDA device (--cpu runs gloo ranks on the CPU)", file=sys.stderr)
        sys.exit(1)
    if not args.cpu:
        print(card_line(), flush=True)
    cfg = default_cfg(args.problem, args.batch_per_chip, args.ticks, device="cpu" if args.cpu else "cuda")
    t0 = time.perf_counter()
    results = run(args.nproc, cfg)
    summary = report(results, cfg, log=lambda m: print(m, flush=True))
    summary.update(nproc=args.nproc, wall_s=time.perf_counter() - t0)
    text = json.dumps(summary, default=lambda x: x.tolist() if hasattr(x, "tolist") else str(x))
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    if summary["failed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
