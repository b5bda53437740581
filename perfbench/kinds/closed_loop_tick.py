"""Traffic kind "closed_loop_tick": B controllers ticked back to back, each
tick closed through the host as a controller's loop is: the tick's x0 (one
row a controller, drawn from the seed into host memory in set-up) copied to
the card, the program's tick (`MPCController.__call__`: on a card the
replayed CUDA graph), u0 copied back to the host and waited for. Each tick
starts from the state the previous tick returned (no restart).

Set-up (counted in setup_s): the transcription, the controller, the cold
start, the x0 pool and `warmup_ticks` closed-loop ticks (the first captures
the graph). The window:
closed-loop ticks until `seconds` have passed. What the window keeps for the
check: the state each sampled tick starts from and what it returns, for
`sample_rows` rows drawn from the seed, at `sample_ticks` ticks drawn from
the seed and at the last tick."""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np
import torch

from perfbench import cost, generator, program, trace
from perfbench.reference import trapeze

STAGES = {"prepare": "kkt.prepare", "_assemble": "kkt.assemble", "_block_solve": "kkt.block_solve",
          "solve": "kkt.solve"}


class Clock:
    """A closed-loop tick's start and end: CUDA events on a card (the
    device's clock), the host clock elsewhere (the CPU tests)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


def closed_tick(ctrl, clock, states, x0_host, ranges: bool):
    """One closed-loop tick: (states, u0 on the host, KKT, start, end)."""
    r = trace.rng if ranges else (lambda name: contextlib.nullcontext())
    dev = states.z.device
    with r("tick"):
        m0 = clock.mark()
        with r("x0_to_card"):
            x0 = x0_host.to(dev, non_blocking=True)
        with r("replay"):
            states, u0, kkt, _ = ctrl(states, x0)
        with r("u0_to_host"):
            u0h = u0.cpu()
        m1 = clock.mark()
        clock.wait(m1)
    return states, u0h, kkt, m0, m1


def run(ctx: dict) -> dict:
    cfg, mix, seed = ctx["cfg"], ctx["mix"], ctx["seed"]
    dev = torch.device(ctx["device"])
    B = mix["batch"]
    clock = Clock(dev)
    program.build_kernels(dev)
    dtype, solve_dtype = program.precision(cfg)
    prob, docp = program.transcribe(cfg, dev, dtype)
    ctrl = program.controller(cfg, docp, solve_dtype)
    warm, cold = program.cold_start(cfg, prob, docp, ctrl)
    pool = torch.from_numpy(generator.x0_pool(mix, seed, mix["pool_ticks"], slice(0, B))).to(dtype)
    if dev.type == "cuda":
        pool = pool.pin_memory()
    K = pool.shape[0]
    states = program.broadcast(warm, B)
    del warm

    # warm-up: the first tick captures the tick's graph
    host = []
    while len(host) < mix["warmup_ticks"]:
        h0 = time.perf_counter()
        states, *_ = closed_tick(ctrl, clock, states, pool[len(host) % K], False)
        host.append(time.perf_counter() - h0)
    tick_s = float(np.median(host[1:]))
    captures = ctrl.captures
    expected = max(2, int(ctx["seconds"] / tick_s))
    picks = set(int(f * 0.9 * expected) for f in generator.fractions(seed, 0, mix["sample_ticks"]))
    setup_epoch = time.time()

    # the window
    tick_ms, u0s, kept, last_in = [], [], {}, None
    start = time.perf_counter()
    k = 0
    while True:
        inp = states
        states, u0h, kkt, m0, m1 = closed_tick(ctrl, clock, inp, pool[k % K], False)
        tick_ms.append(clock.ms(m0, m1))
        u0s.append(u0h)
        if k in picks:
            kept[k] = (inp, states, u0h, kkt)
        last_in = (k, inp, states, u0h, kkt)
        k += 1
        elapsed = time.perf_counter() - start
        if elapsed >= ctx["seconds"]:
            break
    kept[last_in[0]] = last_in[1:]
    rec = dict(B=B, ticks=k, window_s=elapsed, setup_epoch=setup_epoch, first_tick_s=host[0],
               captures_in_window=ctrl.captures - captures, tick_ms=tick_ms,
               host_gap_ms=(1e3 * elapsed - sum(tick_ms)) / k)
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec["failed_detail"] = _failed(cfg, u0s)
    rec["failed"] = rec["failed_detail"]["count"]
    rec["attempted"] = B * k

    if ctx["trace"]:
        rec.update(_traced(ctx, ctrl, clock, states, pool, B, solve_dtype))

    # the samples, then the program's state goes before the reference runs
    picked_rows = torch.as_tensor(generator.sample(seed, 1, B, mix["sample_rows"]))
    samples = []
    for k, (inp, out, u0h, _) in sorted(kept.items()):
        x0 = pool[k % K][picked_rows].double()
        on_dev = picked_rows.to(dev)
        samples.append(dict(x0=x0, inp=[a[on_dev].double().cpu() for a in inp],
                            out=[a[on_dev].double().cpu() for a in out], u0=u0h[picked_rows].double()))
    del ctrl, states, kept, last_in, inp, out, u0s, docp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["checks"] = judge(cfg, samples, dev, ctx["control"], cold)
    return finish(rec, ctx)


def _failed(cfg, u0s) -> dict:
    """Solves whose u0 is not finite or lies outside the control box: the
    count, by kind, the first tick with one, and the largest excess."""
    p = cfg["problem"]
    lo, hi = trapeze._bound(p["u_lower"]), trapeze._bound(p["u_upper"])
    out = dict(count=0, nonfinite=0, outside=0, first_tick=None, excess=0.0)
    for k, u in enumerate(u0s):
        u = u.double().numpy()
        nonfinite = ~np.isfinite(u).all(axis=1)
        excess = np.maximum(lo - u, u - hi).max(axis=1)
        outside = np.isfinite(u).all(axis=1) & (excess > 0)
        n = int((nonfinite | outside).sum())
        if n and out["first_tick"] is None:
            out["first_tick"] = k
        out["count"] += n
        out["nonfinite"] += int(nonfinite.sum())
        out["outside"] += int(outside.sum())
        if outside.any():
            out["excess"] = max(out["excess"], float(excess[outside].max()))
    return out


def _traced(ctx, ctrl, clock, states, pool, B, solve_dtype) -> dict:
    """The traced slice: `trace_ticks` closed-loop ticks under the profiler
    (the device's busy time, the top device operations, the idle gaps; the
    profiler itself slows each graph launch by milliseconds, so the slice's
    own length is no tick time), then `eager_profile_ticks` ticks of the
    same tick run op by op with the benchmark's ranges around the layers
    (device ms a tick by layer)."""
    mix, cfg = ctx["mix"], ctx["cfg"]
    K = pool.shape[0]
    out = {}

    def replayed():
        nonlocal states
        ms = []
        for k in range(mix["trace_ticks"]):
            states, _, _, m0, m1 = closed_tick(ctrl, clock, states, pool[k % K], True)
            ms.append(clock.ms(m0, m1))
        return ms

    trace.profile(lambda: closed_tick(ctrl, clock, states, pool[0], True))  # the profiler's first start
    ms, prof, wall = trace.profile(replayed)
    tr = trace.Trace(prof)
    busy = tr.busy_s()
    out.update(busy_s=busy, trace_window_s=wall, busy_ms_per_tick=1e3 * busy / len(ms), traced_tick_ms=ms,
               top_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
    n = mix["eager_profile_ticks"]
    stage = _eager_stages(ctx, ctrl, states, pool, n) if n else None
    if stage:
        out["stage_ms"] = stage
    if stage and "kernel:cr" in stage:  # the CR kernel's names (perfbench/kernels/cr.txt) seen
        P, bs, wb = cost.trapeze_chain(ctrl.docp.n, ctrl.docp.m, cfg["grid_size"])
        itemsize = torch.finfo(solve_dtype or ctrl.dtype).bits // 8
        bound = cost.bound_s(*cost.block_solve(itemsize, P, bs, wb, B)) * 1e3 * cfg["newton_steps"]
        out["block_solve_bound_ms"] = bound
        out["block_solve_ms"] = stage["kernel:cr"] + stage.get("kkt.block_solve", 0.0)
    return out


def _eager_stages(ctx, ctrl, states, pool, n):
    """Device ms a tick by the benchmark's ranges over n ticks of the tick
    run op by op (`MPCController.eager`: the kernels the graph replays, each
    linked to the host op that launched it): the KKT operator's methods
    (STAGES); the rest of the tick (the shift, x0 rows, the resolve's
    derivatives, barrier terms, residuals, the step to the boundary, the
    state update) is "update", the CR kernel "kernel:cr". None, said on
    standard error, where a KKT range saw no device time: the split would
    put that method's work under another stage."""
    dev = states.z.device
    eager = program.controller(ctx["cfg"], ctrl.docp, ctrl.kkt.solve_dtype)

    def ticks():
        s = states
        for k in range(n):
            s, *_ = eager.eager(s, pool[k].to(dev))
    with trace.wrapped(eager.kkt, STAGES):
        _, prof, _ = trace.profile(ticks)
    stage = trace.Trace(prof).stage_ms(n, outside="update")
    empty = [r for r in STAGES.values() if r != "kkt.solve" and not stage.get(r)]
    if empty:
        print(f"perfbench: no device time in the range(s) {', '.join(empty)}: no stage split", file=sys.stderr)
        return None
    return stage


def judge(cfg: dict, samples: list, dev, control: bool = False, cold: dict = None) -> dict:
    """The reference's tick from each sample's starting state, against what
    the program returned: u0_gap, state_gap (each relative to max(1, the
    reference's inf-norm)) and kkt (the reference's KKT error of the
    program's state), the worst over samples; float64 on `dev`, in blocks.
    With `control`, the reference at the configuration's "control"
    precision takes the program's place (the program's own float32 tick
    fails to run: PERF.md). cold_start_kkt: the reference's KKT error of
    the cold start the ticks start from (`trapeze.cold_start_error`; under
    the control, its answer rounded to float32)."""
    import importlib

    eqs = importlib.import_module(f"perfbench.reference.{cfg['name']}")
    tr = trapeze.Trapeze(cfg, eqs, device=dev)
    iters = cfg["newton_steps"]
    one = torch.func.vmap(lambda st, x0: trapeze.tick(tr, st, x0, iters))
    kkt_of = torch.func.vmap(lambda st, x0: trapeze.tick_kkt(tr, st, x0))
    inp = [torch.cat([s["inp"][f] for s in samples]).to(dev) for f in range(7)]
    out = [torch.cat([s["out"][f] for s in samples]).to(dev) for f in range(7)]
    x0 = torch.cat([s["x0"] for s in samples]).to(dev)
    u0 = torch.cat([s["u0"] for s in samples]).to(dev)
    if control:
        dt, sd = (program.DTYPES[cfg["control"][k]] for k in ("newton", "block_solve"))
        low = trapeze.Trapeze(cfg, eqs, device=dev, dtype=dt)
        lowtick = torch.func.vmap(lambda st, x: trapeze.tick(low, st, x, iters, sd))
        parts = [lowtick(trapeze.State(*(a[i:i + 32].to(dt) for a in inp)), x0[i:i + 32].to(dt))
                 for i in range(0, x0.shape[0], 32)]
        out = [torch.cat([p[0][f] for p in parts]).double() for f in range(7)]
        u0 = torch.cat([p[1] for p in parts]).double()
    ref_states, ref_u0, ref_kkt = [], [], []
    for i in range(0, x0.shape[0], 32):
        st, u, _ = one(trapeze.State(*(a[i:i + 32] for a in inp)), x0[i:i + 32])
        ref_states.append(st)
        ref_u0.append(u)
        ref_kkt.append(kkt_of(trapeze.State(*(a[i:i + 32] for a in out)), x0[i:i + 32]))
    ref = [torch.cat([s[f] for s in ref_states]) for f in range(7)]
    ru0 = torch.cat(ref_u0)

    def gap(a, b):
        scale = torch.clamp(b.abs().amax(dim=1), min=1.0)
        return float(((a - b).abs().amax(dim=1) / scale).max())

    state_gap = max(gap(a, b) for a, b in zip(out, ref) if a.shape[1])
    low = (lambda a: a.float().double()) if control else (lambda a: a)
    start = _nan_max(trapeze.cold_start_error(tr, cold, low)) if cold else 0.0
    return dict(u0_gap=_nan_max(gap(u0, ru0)), state_gap=_nan_max(state_gap), cold_start_kkt=start,
                kkt=_nan_max(float(torch.cat(ref_kkt).max())), samples=len(x0))


def _nan_max(x: float) -> float:
    return float("inf") if x != x else x


def finish(rec: dict, ctx: dict) -> dict:
    """The run's record: the end-to-end metrics over the whole window, the
    checks, the readers' inputs."""
    checks = {key: v for key, v in rec["checks"].items() if key != "samples"}
    e2e = dict(mpc_solves_per_s=rec["B"] * rec["ticks"] / rec["window_s"],
               tick_ms_p95=float(np.percentile(rec["tick_ms"], 95)))
    out = dict(kind="closed_loop_tick", e2e=e2e, checks=checks, samples=rec["checks"]["samples"],
               attempted=rec["attempted"], failed=rec["failed"], memory_peak_bytes=rec["memory_peak_bytes"],
               setup_epoch=rec["setup_epoch"],
               info=dict(ticks=rec["ticks"], window_s=rec["window_s"], captures_in_window=rec["captures_in_window"],
                         tick_ms_pct={q: float(np.percentile(rec["tick_ms"], q)) for q in (50, 90, 95, 99, 100)},
                         tick_ms_p50_by_tenth=[round(float(np.median(a)), 3) for a in np.array_split(rec["tick_ms"], 10)],
                         failed=rec["failed_detail"], first_tick_s=rec["first_tick_s"]),
               rec=rec)
    if ctx["trace"]:
        out.update(busy_s=rec["busy_s"], trace_window_s=rec["trace_window_s"],
                   breakdown=dict(device_ops=rec["top_ops"], idle_gaps=rec["idle_gaps"]))
    return out
