"""Timed run of the port's compiled time-sharded paths over NCCL, one card
per rank, at full width.

    python -m ctdirect_tpu_torch.shard_timing --nproc 4 [--json PATH]

It spawns an NCCL world of --nproc ranks (parallel/spmd.py; one card each)
and runs, for every time-axis size D (the powers of two up to --nproc; the
mesh is batch = nproc / D x time = D):
  1. the double-integrator MPC tick (trapeze N=100, B=512 in all, f64 block
     solve, 3 Newton steps) over batch = nproc / 2 x time = 2 (1 x 1 on one
     card), from one cold-start warm state over one seeded x0 sequence: the
     replayed tick (a CUDA graph with its halos, all_reduce and all_gathers
     inside; the first call captures and is not timed) and the eager tick
     (`MPCController.eager`), 2 warm-up + 30 timed ticks each, CUDA events
     with a synchronize per tick (p50 / p90 per rank), beside the one-card
     replayed tick of the whole batch on each rank;
  2. the distributed CR (`make_sharded_tridiag_solver`) at each D on the
     tick's chain (P=128, bs=5, wb=7, B=512) and on Goddard's (P=256, bs=19,
     wb=8, B=1), f64, from a seeded chain: replayed and eager ms (CUDA
     events, median of 20 calls), beside the CR kernel on one card at the
     same chain;
  3. BASELINE config 2 (Goddard, GL2 constant control, N=200, f64, tol 1e-8,
     adaptive mu) through `DOCPSolver(kkt=TimeShardedKKT)` at each D: the
     compiled first call (captures), a replay and the eager solve
     (`ipm_solve`), host clock to a synchronize. With cfg
     "goddard_eager_iters" = K the eager solve runs the first K iterations
     only, against the same K iterations compiled (a DOCPSolver of its own).
It checks each compiled form against its eager form (ticks and the
distributed CR within GRAPH_TOL, bitwise expected; the solve's status and
objective within SOLVE_RTOL), the tick's max KKT, the tick's u0 against the
one-card tick, the distributed CR against the kernel, and that the ranks of
each time axis hold the same bytes (u0, the solve's z and its flag reads)
and staged nothing through the host. One more replay of the tick and of
the distributed CR runs under torch.profiler, which must see the CR
kernel's CUDA launches that the wrapper counts in it (its root solves x the
plan of a D-block chain; utils/profiling.py's kernel_events, which reports
CUPTI's dropped records). Goddard's replay is not profiled: its graphs are
the B=1 segment graphs whose launches chip_smoke.py's phase 10 profiles,
and parsing the profile of its 94 distributed solves takes ~100 s of host
time (PERF.md). It prints the card's name and power limit (nvidia-smi), one
line per measurement and, last, one JSON object (also written to --json); a
failed check exits non-zero.

`run(nproc, cfg)` and `report(ranks, cfg)` are the same run and checks for a
caller that picks its own sizes (chip_smoke.py's phase 14f: one rank,
time=1)."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the tick (bench.py's main path) and the chains (the tick's and Goddard's,
# padded to a power of two)
TICK = dict(B=512, N=100, iters=3, warmup=2, timed=30, seed=0)
CHAINS = {"tick": (128, 5, 7, 512), "goddard": (256, 19, 8, 1)}
CHAIN_CALLS = 20
# BASELINE config 2 (BASELINE.json:8) with tests/test_accuracy.py:78-84's options
GODDARD = dict(N=200, scheme="gauss_legendre_2_constant_control", tol=1e-8, mu_strategy="adaptive")
# a compiled form against its eager form (PERF.md section 2)
GRAPH_TOL = 1e-13
SOLVE_RTOL = 1e-8
KKT_MAX = 1e-10
ONE_CARD_TOL = 1e-10
KERNEL_TOL = 1e-10  # x max(1, max |x|)
TIMEOUT = 1200.0


def default_cfg(nproc: int) -> dict:
    """The sizes of the command line's run on `nproc` cards."""
    sizes = [1 << k for k in range(nproc.bit_length()) if (1 << k) <= nproc]
    return dict(tick=dict(TICK, time=min(2, nproc), one_card=True), chains=CHAINS, chain_sizes=sizes[-2:],
                goddard_sizes=sizes[-2:])


def chain(P, bs, wb, B, seed, device):
    """A random well-conditioned symmetric lane-minor chain (the CR
    recurrences assume symmetric A and F), f64, on `device`."""
    rng = np.random.default_rng(seed)
    shift = 4.0 if bs <= 12 else 4.0 + bs
    A = rng.standard_normal((P, bs, bs, B)) * 0.3
    A = A + np.swapaxes(A, 1, 2) + np.eye(bs)[None, :, :, None] * shift
    Bp = rng.standard_normal((P, bs, bs, B)) * 0.3
    Bp[-1] = 0.0
    E = rng.standard_normal((P, bs, wb, B)) * 0.2
    F = rng.standard_normal((wb, wb, B)) * 0.2
    F = F + np.swapaxes(F, 0, 1) + np.eye(wb)[:, :, None] * (4.0 + P)
    r = rng.standard_normal((P, bs, B))
    rb = rng.standard_normal((wb, B))
    return tuple(torch.tensor(x, dtype=torch.float64, device=device) for x in (A, Bp, E, F, r, rb))


def event_ms(fn):
    """(fn(), its CUDA-event ms to a synchronize)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def max_diff(xs, ys) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(xs, ys))


def _witness(kernel, fn, D):
    """One call of fn (a replay) under torch.profiler: the CR kernel's
    launches that the wrapper counts in it, and the CUDA launches of their
    plan (a D-block root chain each) that the profiler must see; a failed
    check is recorded (the ranks stay in lockstep), not raised."""
    from ctdirect_tpu_torch.utils.profiling import kernel_events

    roots = len(kernel.plan(D, 1, 0, 1, 8))
    counted = {}

    def run():
        l0 = kernel.launches
        fn()
        counted["launches"] = kernel.launches - l0
        return counted["launches"] * roots

    try:
        rec = kernel_events(run)
    except AssertionError as e:
        return dict(counted, error=str(e))
    return dict(counted, seen=rec["seen"], dropped=rec["dropped"], profiles=rec["tries"])


def _ticks(tick, states, xs, warmup):
    """xs through `tick` from `states`; per tick CUDA-event ms (the first
    `warmup` untimed), u0 and KKT; the final states."""
    ms, u0s, kkts = [], [], []
    for k, x0 in enumerate(xs):
        (states, u0, kkt, _), t = event_ms(lambda: tick(states, x0))
        if k >= warmup:
            ms.append(t)
        u0s.append(u0)
        kkts.append(kkt)
    return dict(states=states, u0s=u0s, kkts=kkts, p50=float(np.percentile(ms, 50)),
                p90=float(np.percentile(ms, 90)), kkt_max=max(float(k.max()) for k in kkts))


def _tick(world, cfg, kernel):
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import MPCController, broadcast_state
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    dev, nt = world.device, cfg["time"]
    docp = ct.transcribe(get_problem("double_integrator_minenergy").ocp, grid_size=cfg["N"], scheme="trapeze",
                         device=dev)
    mesh = world.mesh((world.size // nt, nt), ("batch", "time"))
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=cfg["iters"], mesh=mesh, time_axis="time",
                         device=dev)
    one = None
    if cfg.get("one_card") or cfg.get("warm") is None:
        one = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=cfg["iters"], kkt_algorithm="cr",
                            device=dev)
    if cfg.get("warm") is None:
        warm = one.cold_start(options=ct.IPMOptions(tol=1e-8, max_iter=60))
    else:
        warm = warm_state_from_numpy(cfg["warm"], dev)
    if cfg.get("x0s") is None:
        rng = np.random.default_rng(cfg["seed"])
        x0s = [0.03 * rng.standard_normal((cfg["B"], 2)) for _ in range(cfg["warmup"] + cfg["timed"])]
    else:
        x0s = cfg["x0s"]
    xs = [torch.tensor(x, dtype=torch.float64, device=dev) for x in x0s]
    rows = cfg["B"] // ctrl.axis.size
    mine = slice(ctrl.axis.rank * rows, (ctrl.axis.rank + 1) * rows)
    states0 = broadcast_state(warm, rows)

    _, first_s = host_s(lambda: ctrl(states0, xs[0][mine]))
    m0, s0, l0, g0 = ctrl.kkt.axis.messages, ctrl.kkt.axis.staged_messages, kernel.launches, kernel.grid_launches
    replay = _ticks(ctrl, states0, [x[mine] for x in xs], cfg["warmup"])
    counts = dict(messages=ctrl.kkt.axis.messages - m0, staged=ctrl.kkt.axis.staged_messages - s0,
                  launches=kernel.launches - l0, grid_launches=kernel.grid_launches - g0)
    profiled = _witness(kernel, lambda: ctrl(replay["states"], xs[-1][mine]), nt)
    eager = _ticks(ctrl.eager, states0, [x[mine] for x in xs], cfg["warmup"])
    graph = next(iter(ctrl.graphs.values()), None)
    out = dict(rows=(mine.start, mine.stop), time_rank=ctrl.kkt.axis.rank, graphed=ctrl.graphed,
               captures=ctrl.captures, first_s=first_s, capture_s=0.0 if graph is None else graph.capture_s,
               pool_mib=0.0 if graph is None else graph.pool_bytes / 2**20, ticks=len(xs), timed=len(xs) - cfg["warmup"],
               replay=dict(p50=replay["p50"], p90=replay["p90"], kkt_max=replay["kkt_max"], **counts),
               eager=dict(p50=eager["p50"], p90=eager["p90"], kkt_max=eager["kkt_max"]),
               replay_eager=max_diff((*replay["u0s"], *replay["kkts"], *replay["states"]),
                                     (*eager["u0s"], *eager["kkts"], *eager["states"])),
               u0=replay["u0s"][-1].cpu().numpy(), u0_digest=digest(*replay["u0s"]), profiled=profiled)
    if cfg.get("one_card"):
        states = broadcast_state(warm, cfg["B"])
        one(states, xs[0])  # the first call of this signature captures
        ref = _ticks(one, states, xs, cfg["warmup"])
        out["one_card"] = dict(p50=ref["p50"], p90=ref["p90"],
                               u0_diff=float((replay["u0s"][-1] - ref["u0s"][-1][mine]).abs().max()))
    return out


def _chains(world, cfg, kernel):
    from ctdirect_tpu_torch.parallel import make_sharded_tridiag_solver

    dev, out = world.device, []
    for D in cfg["chain_sizes"]:
        mesh = world.mesh((world.size // D, D), ("batch", "time"))
        for tag, (P, bs, wb, B) in cfg["chains"].items():
            A, Bp, E, F, r, rb = full = chain(P, bs, wb, B, seed=1, device=dev)
            args = (A, Bp[:-1], E, F, r, rb)
            solve = make_sharded_tridiag_solver(mesh, "time", P, bs, wb)
            _, first_s = host_s(lambda: solve(*args))
            ax = solve.axis
            m0, s0, l0, g0 = ax.messages, ax.staged_messages, kernel.launches, kernel.grid_launches
            replay = solve(*args)
            torch.cuda.synchronize()
            counts = dict(messages=ax.messages - m0, staged=ax.staged_messages - s0, launches=kernel.launches - l0,
                          grid_launches=kernel.grid_launches - g0)
            profiled = _witness(kernel, lambda: solve(*args), D)
            eager = solve.eager(*args)
            Xk, xbk = kernel(*full)
            rec = dict(D=D, chain=tag, shape=(P, bs, wb, B), graphs=len(solve.graphs), first_s=first_s,
                       replay_eager=max_diff(replay, eager), bitwise=all(map(torch.equal, replay, eager)),
                       kernel_diff=max_diff(replay, (Xk, xbk)),
                       scale=max(1.0, float(Xk.abs().max()), float(xbk.abs().max())),
                       digest=digest(*replay), profiled=profiled, **counts)
            for name, fn in (("replay_ms", lambda: solve(*args)), ("eager_ms", lambda: solve.eager(*args)),
                             ("kernel_ms", lambda: kernel(*full))):
                rec[name] = float(np.median([event_ms(fn)[1] for _ in range(CHAIN_CALLS)]))
            out.append(rec)
            del full, A, Bp, E, F, r, rb, args, replay, eager, Xk, xbk, solve
    return out


def _goddard(world, cfg, kernel):
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import TimeShardedKKT
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.interface import DOCPSolver

    dev, out = world.device, []
    gp = get_problem("goddard")
    sign = -1.0 if gp.ocp.maximize else 1.0
    for D in cfg["goddard_sizes"]:
        mesh = world.mesh((world.size // D, D), ("batch", "time"))
        gd = ct.transcribe(gp.ocp, grid_size=GODDARD["N"], scheme=GODDARD["scheme"], device=dev)
        opts = ct.IPMOptions(tol=GODDARD["tol"], mu_strategy=GODDARD["mu_strategy"], kkt_mode="cr")
        run = DOCPSolver(gd, opts, kkt=TimeShardedKKT(gd, mesh, axis="time"))
        args = (gd.initial_guess(gp.init), gd._z_lb, gd._z_ub, gd._c_lb, gd._c_ub)
        (first, _), first_s = host_s(lambda: run(*args))
        ax = run.kkt.axis
        m0, s0, l0, g0 = ax.messages, ax.staged_messages, kernel.launches, kernel.grid_launches
        b0 = run.kkt.block_solves
        run.stats.flag_log = []
        (rep, _), replay_s = host_s(lambda: run(*args))
        counts = dict(messages=ax.messages - m0, staged=ax.staged_messages - s0, launches=kernel.launches - l0,
                      grid_launches=kernel.grid_launches - g0, block_solves=run.kkt.block_solves - b0)
        flags = run.stats.flag_log
        run.stats.flag_log = None
        vs, iters, short = rep, cfg.get("goddard_eager_iters"), run
        if iters is not None:  # the eager solve's first iterations, against the same compiled
            short = DOCPSolver(gd, opts.replace(max_iter=iters), kkt=TimeShardedKKT(gd, mesh, axis="time"))
            vs, _ = short(*args)
        (ref, _), eager_s = host_s(lambda: short.eager(*args))
        out.append(dict(
            D=D, time_rank=ax.rank, graphed=run.graphed, captures=run.captures, capture_s=run.capture_s,
            first_s=first_s, replay_s=replay_s, eager_s=eager_s, eager_iters=iters,
            status=(first.status, rep.status, int(ref.status)),
            iterations=(first.iterations, rep.iterations, int(ref.iterations)),
            objective=tuple(sign * float(x.objective) for x in (first, rep, ref)),
            eager_vs=dict(status=int(vs.status), iterations=int(vs.iterations), objective=sign * float(vs.objective)),
            replay_first=max_diff((rep.z,), (first.z,)), finite=bool(torch.isfinite(rep.z).all()),
            flag_reads=len(flags), flags_digest=hashlib.sha256(repr(flags).encode()).hexdigest()[:16],
            z_digest=digest(rep.z), **counts))
        del run, short, gd
    return out


def _rank(world, cfg):
    """One rank's measurements (numbers and small numpy arrays)."""
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel

    kernel.library()
    out = dict(rank=world.rank, card=torch.cuda.get_device_name(world.device))
    if cfg.get("tick"):
        out["tick"] = _tick(world, cfg["tick"], kernel)
    out["chains"] = _chains(world, cfg, kernel) if cfg.get("chain_sizes") else []
    out["goddard"] = _goddard(world, cfg, kernel) if cfg.get("goddard_sizes") else []
    return out


def run(nproc: int, cfg: dict, timeout: float = TIMEOUT) -> list:
    """The measurements of `cfg` on an NCCL world of `nproc` ranks (one card
    each); returns the ranks' results in rank order."""
    from ctdirect_tpu_torch.parallel.spmd import launch

    # the ranks' kineto prints CUPTI's dropped records (_witness) at this level
    os.environ.setdefault("KINETO_LOG_LEVEL", "2")
    return launch(_rank, nproc, device="cuda", backend="nccl", args=(cfg,), timeout=timeout)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _check_profiled(q, what):
    """A replay's profile saw its CR kernel launches (_witness)."""
    p = q["profiled"]
    _check("error" not in p and p["launches"] > 0, f"{what}: the profiled replay: {p}")


def _profiled_note(q):
    p = q["profiled"]
    return (f"; profiled replay: {p['seen']} CR kernel CUDA launches seen = {p['launches']} root solves x the plan "
            f"(CUPTI dropped {p['dropped']} records over {p['profiles']} profiles)")


def report(ranks: list, cfg: dict, log=print) -> dict:
    """Check the ranks' results (module docstring) and print one line per
    measurement; returns the summary (JSON-ready). Raises AssertionError on
    a failed check."""
    n = len(ranks)
    summary = dict(nproc=n, card=ranks[0]["card"])
    if "tick" in ranks[0]:
        c = cfg["tick"]
        tag = f"2-D tick (batch={n // c['time']} x time={c['time']}, B={c['B']} N={c['N']}, f64)"
        for r in ranks:
            t = r["tick"]
            mates = [q["tick"] for q in ranks if q["tick"]["rows"] == t["rows"]]
            _check(t["graphed"] and t["captures"] == 1, f"{tag} rank {r['rank']}: graphed {t['graphed']}, "
                                                        f"{t['captures']} captures")
            _check(t["replay_eager"] <= GRAPH_TOL, f"{tag} rank {r['rank']}: replay vs eager {t['replay_eager']:.3e}")
            _check(max(t["replay"]["kkt_max"], t["eager"]["kkt_max"]) < KKT_MAX, f"{tag} rank {r['rank']}: KKT")
            _check(t["replay"]["messages"] > 0 and t["replay"]["staged"] == 0,
                   f"{tag} rank {r['rank']}: {t['replay']['messages']} messages, {t['replay']['staged']} staged")
            _check(len(mates) == c["time"] and len({q["u0_digest"] for q in mates}) == 1,
                   f"{tag} rank {r['rank']}: its time group's u0 differ")
            _check_profiled(t, f"{tag} rank {r['rank']}")
            if "one_card" in t:
                _check(t["one_card"]["u0_diff"] <= ONE_CARD_TOL, f"{tag} rank {r['rank']}: u0 vs the one-card tick "
                                                                 f"{t['one_card']['u0_diff']:.3e}")
            ref = f"; one-card replayed tick of B={c['B']} {t['one_card']['p50']:.3f} / {t['one_card']['p90']:.3f} " \
                  f"ms, u0 diff {t['one_card']['u0_diff']:.2e}" if "one_card" in t else ""
            per = t["ticks"]
            log(f"{tag} rank {r['rank']} rows {t['rows'][0]}-{t['rows'][1]}: replayed {t['replay']['p50']:.3f} / "
                f"{t['replay']['p90']:.3f} ms p50 / p90, eager {t['eager']['p50']:.3f} / {t['eager']['p90']:.3f} ms "
                f"({t['timed']} timed after {per - t['timed']}, CUDA events){ref}; replay vs eager "
                f"{t['replay_eager']:.1e}; max KKT {t['replay']['kkt_max']:.2e}; first call {t['first_s']:.3f} s "
                f"(capture {t['capture_s']:.3f} s, pool {t['pool_mib']:.1f} MiB); per tick "
                f"{t['replay']['messages'] / per:g} messages, {t['replay']['launches'] / per:g} kernel launches"
                f"{_profiled_note(t)}")
        summary["tick"] = [dict({k: v for k, v in r["tick"].items() if k not in ("u0", "u0_digest")}, rank=r["rank"])
                           for r in ranks]
    for i, rec in enumerate(ranks[0]["chains"]):
        recs = [r["chains"][i] for r in ranks]
        tag = f"distributed CR D={rec['D']} on the {rec['chain']} chain (P, bs, wb, B = {rec['shape']}, f64)"
        for q in recs:
            _check(q["graphs"] == 1 and q["replay_eager"] <= GRAPH_TOL, f"{tag}: replay vs eager {q}")
            _check(q["kernel_diff"] <= KERNEL_TOL * q["scale"], f"{tag}: vs the kernel {q['kernel_diff']:.3e}")
            _check(q["staged"] == 0 and q["messages"] > 0, f"{tag}: messages {q['messages']}, staged {q['staged']}")
            _check_profiled(q, tag)
        _check(len({q["digest"] for q in recs}) == 1, f"{tag}: the ranks' X and xb differ")
        log(f"{tag}: replayed {', '.join('%.4f' % q['replay_ms'] for q in recs)} ms, eager "
            f"{', '.join('%.3f' % q['eager_ms'] for q in recs)} ms on ranks 0-{n - 1}; the one-card kernel "
            f"{rec['kernel_ms']:.4f} ms (CUDA events, medians); replay vs eager {rec['replay_eager']:.1e} "
            f"({'bitwise' if all(q['bitwise'] for q in recs) else 'not bitwise'}), vs the kernel "
            f"{rec['kernel_diff']:.2e} (scale {rec['scale']:.3g}); per solve {rec['messages']} messages, "
            f"{rec['launches']} kernel launch ({rec['grid_launches']} CUDA launches) on rank 0{_profiled_note(rec)}")
    summary["chains"] = [[r["chains"][i] for r in ranks] for i in range(len(ranks[0]["chains"]))]
    for i, g in enumerate(ranks[0]["goddard"]):
        recs = [r["goddard"][i] for r in ranks]
        tag = f"goddard GL2 N={GODDARD['N']} f64 over time={g['D']}"
        for q in recs:
            vs = q["eager_vs"]
            rel = abs(vs["objective"] - q["objective"][2]) / abs(q["objective"][2])
            _check(q["graphed"] and q["captures"] > 0 and q["finite"], f"{tag}: not compiled {q}")
            _check(q["status"][0] == q["status"][1] == 0 and vs["status"] == q["status"][2] and rel <= SOLVE_RTOL,
                   f"{tag}: compiled vs eager {q['status']}, {vs}, objective rel diff {rel:.3e}")
            _check(q["replay_first"] == 0.0 and q["messages"] > 0 and q["staged"] == 0,
                   f"{tag}: replay vs first call, messages, staged {q}")
        _check(len({(q["flags_digest"], q["z_digest"]) for q in recs}) == 1, f"{tag}: the ranks left lockstep")
        log(f"{tag}: compiled first call {', '.join('%.3f' % q['first_s'] for q in recs)} s (capture "
            f"{g['capture_s']:.3f} s, {g['captures']} segment graphs), replay "
            f"{', '.join('%.3f' % q['replay_s'] for q in recs)} s, eager"
            f"{'' if g['eager_iters'] is None else ' (its first %d iterations)' % g['eager_iters']} "
            f"{', '.join('%.3f' % q['eager_s'] for q in recs)} s on ranks 0-{n - 1}; status {g['status']}, iterations "
            f"{g['iterations']}, objective {g['objective'][1]!r} (eager {g['objective'][2]!r}, compiled over the same "
            f"iterations {g['eager_vs']['objective']!r}); per replayed solve {g['messages']} messages, "
            f"{g['launches']} kernel launches, {g['block_solves']} block solves, {g['flag_reads']} flag reads (the "
            f"same on every rank)")
    summary["goddard"] = [[r["goddard"][i] for r in ranks] for i in range(len(ranks[0]["goddard"]))]
    return summary


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description="the compiled time-sharded paths over NCCL, timed")
    parser.add_argument("--nproc", type=int, default=4, help="ranks, one card each")
    parser.add_argument("--json", help="also write the JSON summary here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_timing: no CUDA device", file=sys.stderr)
        sys.exit(1)
    cards = card_line()
    print(cards, flush=True)
    cfg = default_cfg(args.nproc)
    t0 = time.perf_counter()
    ranks = run(args.nproc, cfg)
    summary = report(ranks, cfg, log=lambda m: print(m, flush=True))
    summary.update(cards=cards.splitlines(), wall_s=time.perf_counter() - t0)
    text = json.dumps(summary, default=lambda x: x.tolist() if hasattr(x, "tolist") else str(x))
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
