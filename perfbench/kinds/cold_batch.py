"""Traffic kind "cold_batch": a fleet of B controllers re-planned from cold,
call after call: each call of the program's `BatchSolver` (on a card its
segment graphs) solves B instances, each with its own x0 (drawn from the
seed into host memory in set-up, fresh for each call of the pool) in its
boundary rows, all started from the cold start's solution, to the
configuration's tolerance or its iteration cap.

Set-up (counted in setup_s): the transcription, the cold start, the solver,
the x0 pool and `warmup_calls` calls, after which every segment graph that
those calls did not use is captured too, so that no call of the window
captures. The window: calls until `seconds` have passed. What the window
keeps for the check: every call's result (the status of every instance;
`sample_instances` instances drawn from the seed are judged whole).

An instance is one operation: a re-plan within the configuration's budget
of iterations. It has failed where its answer is wrong: z or the objective
not finite, or `successful` against its status. One that stops at the cap
says so (status 1) and has not failed; the share that converged is a check
(`unconverged_share`) and a per-layer metric (`converged_pct.batch`)."""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from perfbench import cost, generator, program, trace


def run(ctx: dict) -> dict:
    cfg, mix, seed = ctx["cfg"], ctx["mix"], ctx["seed"]
    dev = torch.device(ctx["device"])
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel.batch import BatchSolver

    program.build_kernels(dev)
    dtype, _ = program.precision(cfg)
    prob, docp = program.transcribe(cfg, dev, dtype)
    ctrl = program.controller(cfg, docp, None)
    warm, cold = program.cold_start(cfg, prob, docp, ctrl)
    del ctrl
    B = mix["batch"]
    solver = BatchSolver(docp, ct.IPMOptions(**cfg["batch_solver"]), device=dev, dtype=dtype)
    x0_pool = generator.x0_pool(mix, seed, mix["pool_calls"], slice(0, B))
    K = len(x0_pool)
    rows = torch.as_tensor(docp.boundary_row_indices()[list(cfg["x0_rows"])], device=dev)
    c_lb, c_ub = docp.tensor(docp._c_lb), docp.tensor(docp._c_ub)
    z0 = warm.z.detach().clone().expand(B, -1)
    host = torch.from_numpy(x0_pool).to(dtype)
    if dev.type == "cuda":
        host = host.pin_memory()

    def call(k, ranges=False):
        r = trace.rng if ranges else (lambda name: contextlib.nullcontext())
        with r("x0_to_card"):
            x0 = host[k % K].to(dev, non_blocking=True)
            cl = _rhs(c_lb, rows, x0)
            cu = _rhs(c_ub, rows, x0)
        with r("batch_solver"):
            res = solver(z0, cl, cu)
        with r("sync"):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return res

    for k in range(mix["warmup_calls"]):
        call(k)
    graph = solver.graphs.get(B)
    if graph is not None:  # the segments the warm-up calls did not reach: captured (and replayed once) now
        for name in solver.program.segments:
            if name not in graph.graphs:
                graph.run(name)
    captures = solver.captures
    from ctdirect_tpu_torch.solver.ipm import BatchStats

    solver.stats = BatchStats()
    setup_epoch = time.time()

    results, ends = [], []
    start = time.perf_counter()
    k = 0
    while True:
        res = call(mix["warmup_calls"] + k)
        results.append((mix["warmup_calls"] + k, res))
        k += 1
        elapsed = time.perf_counter() - start
        ends.append(elapsed)
        if elapsed >= ctx["seconds"]:
            break
    stats = solver.stats
    rec = dict(B=B, calls=k, window_s=elapsed, call_s=np.diff([0.0] + ends).round(4).tolist(), setup_epoch=setup_epoch,
               captures_in_window=solver.captures - captures,
               memory_peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
               host_syncs=stats.host_syncs, iterations=stats.iterations, kkt_solves=stats.kkt_solves)
    status = torch.stack([r.status for _, r in results]).cpu().numpy()
    successful = torch.stack([r.successful for _, r in results]).cpu().numpy()
    rec["converged"] = int(successful.sum())
    rec["attempted"] = B * k
    rec["wrong"] = int(sum(int((~(torch.isfinite(r.z).all(-1) & torch.isfinite(r.objective))).sum())
                           for _, r in results)) + int((successful != np.isin(status, (0, 4))).sum())

    if ctx["trace"]:
        rec.update(_traced(ctx, solver, call, docp, B, dtype))

    # the sampled instances, then the program's state goes before the reference runs
    picks = generator.sample(seed, 1, B * k, mix["sample_instances"])
    sample = dict(z0=[], x0=[], z=[], lam=[], zL=[], zU=[], objective=[], status=[], successful=[])
    for p in picks:
        c, row = int(p // B), int(p % B)
        idx, res = results[c]
        sample["x0"].append(torch.as_tensor(x0_pool[idx % K][row]))
        sample["z0"].append(z0[row].double().cpu())
        for f in ("z", "lam", "zL", "zU", "objective"):
            value = getattr(res, f)[row]
            if ctx["control"]:  # the answer as a float32 solve would return it at best
                value = value.float()
            sample[f].append(value.double().cpu())
        sample["status"].append(int(res.status[row]))
        sample["successful"].append(bool(res.successful[row]))
    rec["status_counts"] = {int(s): int((status == s).sum()) for s in np.unique(status)}
    rec["status_honest"] = bool(np.all(successful == np.isin(status, (0, 4))))
    del solver, results, res, docp, z0, warm, graph
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["checks"] = judge(cfg, sample, rec, dev, cold, ctx["control"])
    return finish(rec, ctx)


def _rhs(base, rows, x0):
    out = base.expand(x0.shape[0], -1).clone()
    out[:, rows] = x0
    return out


def _traced(ctx, solver, call, docp, B, dtype) -> dict:
    """One graphed call under the profiler, inside the benchmark's own ranges
    around the call's parts (the program opens none inside its segment
    graphs yet: PERF.md): the device's busy time, the block solves' device
    time against their least time, the top device operations and the idle
    gaps (the profiler slows each graph launch, so the call's own length
    under it is no call time)."""
    before = solver.stats.kkt_solves
    trace.profile(lambda: torch.ones(1, device=docp.device) + 1)  # the profiler's first start
    _, prof, wall = trace.profile(lambda: call(0, ranges=True))
    tr = trace.Trace(prof)
    busy = tr.busy_s()
    solves = solver.stats.kkt_solves - before
    stage = tr.stage_ms(1, outside="host")
    P, bs, wb = cost.trapeze_chain(docp.n, docp.m, ctx["cfg"]["grid_size"])
    itemsize = torch.finfo(dtype).bits // 8
    bound = cost.bound_s(*cost.block_solve(itemsize, P, bs, wb, B)) * 1e3 * solves
    return dict(busy_s=busy, trace_window_s=wall,
                block_solve_bound_ms=bound, block_solve_ms=stage.get("kernel:cr", 0.0), traced_block_solves=solves,
                top_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())


def judge(cfg: dict, sample: dict, rec: dict, dev, cold: dict, control: bool) -> dict:
    """kkt_worst: the reference's KKT error of each sampled instance that
    the program says converged (in the solver's stated measure, against its
    tolerance), the worst; objective_gap: the reported objective against the
    reference's objective of the returned z, relative to max(1, |it|), the
    worst over the sample; unconverged_share: the instances of the window
    the program did not bring to its tolerance, over all of them; honest: 0
    where every instance's `successful` matches its status, else 1;
    cold_start_kkt: the reference's KKT error of the cold start every
    instance starts from (under the control, rounded to float32)."""
    import importlib

    from perfbench.reference import trapeze

    eqs = importlib.import_module(f"perfbench.reference.{cfg['name']}")
    tr = trapeze.Trapeze(cfg, eqs, device=dev)
    get = lambda f: torch.stack(sample[f]).to(dev)
    z0, x0, z, lam, zL, zU = (get(f) for f in ("z0", "x0", "z", "lam", "zL", "zU"))
    obj = torch.stack(sample["objective"]).to(dev)
    errs, objs = [], []
    kkt = torch.func.vmap(lambda *a: trapeze.ipm_kkt_error(tr, *a))
    for i in range(0, len(z), 32):
        s = slice(i, i + 32)
        errs.append(kkt(z0[s], x0[s], z[s], lam[s], zL[s], zU[s]))
        objs.append(torch.func.vmap(tr.objective)(z[s]))
    err, ref_obj = torch.cat(errs), torch.cat(objs)
    ok = torch.tensor(sample["successful"], device=dev)
    kkt_worst = float(torch.where(ok, err, 0.0).max()) if bool(ok.any()) else 0.0
    gap = float(((obj - ref_obj).abs() / torch.clamp(ref_obj.abs(), min=1.0)).max())
    start = trapeze.cold_start_error(tr, cold, (lambda a: a.float().double()) if control else (lambda a: a))
    return dict(kkt_worst=_nan_inf(kkt_worst), cold_start_kkt=_nan_inf(start), objective_gap=_nan_inf(gap),
                unconverged_share=1.0 - rec["converged"] / rec["attempted"],
                dishonest_status=0.0 if rec["status_honest"] else 1.0, samples=len(z), judged=int(ok.sum()))


def _nan_inf(x: float) -> float:
    return float("inf") if x != x else x


def finish(rec: dict, ctx: dict) -> dict:
    checks = {k: v for k, v in rec["checks"].items() if k not in ("samples", "judged")}
    out = dict(kind="cold_batch", e2e=dict(cold_solves_per_s=rec["attempted"] / rec["window_s"]), checks=checks,
               samples=rec["checks"]["samples"], attempted=rec["attempted"],
               failed=rec["wrong"], memory_peak_bytes=rec["memory_peak_bytes"],
               setup_epoch=rec["setup_epoch"],
               info=dict(calls=rec["calls"], window_s=rec["window_s"], captures_in_window=rec["captures_in_window"],
                         status_counts=rec["status_counts"], judged=rec["checks"]["judged"],
                         host_syncs=rec["host_syncs"], iterations=rec["iterations"], call_s=rec["call_s"]),
               rec=rec)
    if ctx["trace"]:
        out.update(busy_s=rec["busy_s"], trace_window_s=rec["trace_window_s"],
                   breakdown=dict(device_ops=rec["top_ops"], idle_gaps=rec["idle_gaps"]))
    return out
